"""End-to-end MSA pipeline (port of FAMSA src/msa.cpp CFAMSA).

Stages: sort+dedup -> guide tree (MST-Prim as device rounds on the torch
backend, ops/prim_torch.py; SLINK, UPGMA, NJ and the PartTree/MedoidTree
heuristic on distance rows from K1; both sharded over the mesh a caller
set, parallel/mesh.py:auto_mesh) -> progressive profile
alignment up the tree (batched device DP with device-resident profiles,
ops/dp_torch.py, ops/dp_resident.py; caterpillar runs as device-resident
chunks, ops/dp_chain.py) -> iterative refinement (guided device DP) ->
duplicate restoration and input-order output.  -dist_export writes the
distance CSV instead (tree/distance_export.py)."""

import contextlib
import heapq
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import kernels
from .core import params as P
from .core.aligner import (align_into, construct_profile, split_ready,
                           split_sharded, split_wide)
from .core.construct_fast import drain_gap_queue, reset_gap_queue
from .core.defs import UNKNOWN_SYMBOL
from .core.profile import Profile
from .core.refinement import refine_alignment
from .core.sequence import GappedSequence
from .ops.distance import run_distances
from .tree.distance_export import export_distances
from .tree.fast_tree import FastTree
from .tree.guide_tree import GuideTree
from .tree.mst_prim import mst_prim_tree
from .tree.nj import nj_tree
from .tree.slink import slink_tree
from .tree.upgma import upgma_distance_matrix, upgma_tree
from .utils import logger
from .utils.stats import Statistics, StopWatch


# ----------------------------------------------------------------------
def sort_and_extend(sequences):
    """Stable sort by (length desc, data lexicographic asc) + pad to max
    (msa.cpp:245-279)."""
    order = sorted(range(len(sequences)),
                   key=lambda i: (-sequences[i].length,
                                  sequences[i].data.tobytes()))
    out = [sequences[i] for i in order]
    max_len = out[0].length if out else 0
    for s in out:
        s.resize(max_len, UNKNOWN_SYMBOL)
    return out


def remove_duplicates(sorted_seqs, original2sorted):
    """msa.cpp:338-356; sorted_seqs filtered in place."""
    uniq = [sorted_seqs[0]]
    cur = 0
    for i in range(1, len(sorted_seqs)):
        a, b = sorted_seqs[i], sorted_seqs[i - 1]
        same = (a.length == b.length
                and np.array_equal(a.data[:a.length], b.data[:b.length]))
        if not same:
            cur += 1
            uniq.append(sorted_seqs[i])
        original2sorted[i] = cur
    return uniq


# ----------------------------------------------------------------------
def _make_partial_generator(params, measure):
    """Partial generator used by FastTree (createTreeGenerator semantics):
    each subgroup's tree by SLINK (for MST-Prim too), UPGMA or NJ, its
    rows from a distance backend of its own."""
    method = params.gt_method
    distances = run_distances(params, measure)

    def partial(seqs, tree_list):
        if len(seqs) < 2:
            return
        if method in (P.GT_SLINK, P.GT_MST_PRIM):
            be = distances(seqs, np.float64)
            slink_tree(len(seqs), lambda i: be.row_prefix(i, i), tree_list)
        elif method in (P.GT_UPGMA, P.GT_UPGMA_MODIFIED):
            be = distances(seqs, np.float32)
            dmat = upgma_distance_matrix(len(seqs),
                                         lambda i: be.row_prefix(i, i))
            upgma_tree(dmat, len(seqs), tree_list,
                       modified=(method == P.GT_UPGMA_MODIFIED))
        elif method == P.GT_NJ:
            be = distances(seqs, np.float32)
            dmat = upgma_distance_matrix(len(seqs),
                                         lambda i: be.row_prefix(i, i))
            nj_tree(dmat, len(seqs), tree_list)
        else:
            raise ValueError("Error: Illegal guide tree method.")

    return partial


def build_guide_tree(params, sequences, tree: GuideTree):
    """createTreeGenerator + run (msa.cpp:109-242, 570-573).  On the torch
    backend every distance row comes from K1 (TorchDistanceBackend; the
    default MST-Prim tree from the device Prim, ops/prim_torch.py)."""
    measure = params.distance
    backend = params.backend
    n = len(sequences)
    tree.init_leaves(n)
    tree_list = tree.tree
    distances = run_distances(params, measure)

    def rows(dtype):
        be = distances(sequences, dtype)
        return lambda i: be.row_prefix(i, i)

    if params.gt_heuristic != P.HEUR_NONE:
        with (open(params.seed_file_name, "w") if params.seed_file_name
              else contextlib.nullcontext()) as seed_file:
            ft = FastTree(
                measure,
                _make_partial_generator(params, measure),
                params.medoid.subtree_size,
                params.medoid.sample_size,
                params.medoid.num_evaluations,
                params.medoid.threshold,
                use_clustering=(params.gt_heuristic == P.HEUR_MEDOIDTREE),
                cluster_fraction=params.medoid.cluster_fraction,
                cluster_iters=params.medoid.cluster_iters,
                seed_observer=(_make_seed_dumper(seed_file)
                               if seed_file else None),
                # concurrent depth-0 subtree builds on the host path; on
                # the torch backend they would share one device and one
                # stream, so keep it sequential there
                n_threads=1 if backend == "torch" else (os.cpu_count() or 1),
                # medoid-path distances (seeds, assignment, CLARANS sample)
                # ride K1 on the torch backend (reference FastTree.cpp:
                # 302-330, 385-436)
                backend_factory=distances if backend == "torch" else None,
            )
            ft.run(sequences, tree_list)
        return

    if params.gt_method == P.GT_SLINK:
        slink_tree(n, rows(np.float64), tree_list)
    elif params.gt_method == P.GT_MST_PRIM:
        if backend == "torch" and measure == P.DIST_INDEL075_DIV_LCS:
            from .parallel.mesh import rows_mesh
            mesh = rows_mesh(n, params.device)
            if mesh is not None:
                # the Prim rounds sharded over the mesh
                from .parallel.dist_sharded import mst_prim_tree_sharded
                mst_prim_tree_sharded(sequences, tree_list, mesh)
            else:
                from .ops.prim_torch import mst_prim_tree_torch
                mst_prim_tree_torch(sequences, tree_list,
                                    device=params.device)
            return
        be = distances(sequences, np.float64)
        mst_prim_tree(n, lambda ref, ids: be.row(ref, ids), tree_list,
                      lengths=[s.length for s in sequences],
                      measure=measure)
    elif params.gt_method in (P.GT_UPGMA, P.GT_UPGMA_MODIFIED):
        dmat = upgma_distance_matrix(n, rows(np.float32))
        upgma_tree(dmat, n, tree_list,
                   modified=(params.gt_method == P.GT_UPGMA_MODIFIED))
    elif params.gt_method == P.GT_NJ:
        dmat = upgma_distance_matrix(n, rows(np.float32))
        nj_tree(dmat, n, tree_list)
    else:
        raise ValueError("Error: Illegal guide tree method.")


def _make_seed_dumper(f):
    """Seed observer writing the depth-0 seeds' ids to the open file f
    (-seed_file)."""
    def dump(seeds, depth):
        if depth == 0:
            for s in seeds:
                f.write(s.id[1:] + "\n")
            f.flush()
    return dump


# ----------------------------------------------------------------------
def compute_alignment(params, gapped_sequences, tree_list):
    """Progressive alignment up the guide tree (msa.cpp:360-438).

    gapped_sequences: list of GappedSequence for leaves (mapped order).
    Any topological order yields identical output because each merge is
    deterministic; with the torch backend, independent ready merges are
    batched into single device DP launches."""
    reset_gap_queue()          # discard stale futures from a failed run
    if params.backend == "torch" and len(gapped_sequences) > 2:
        return _compute_alignment_batched(params, gapped_sequences, tree_list)

    n = len(gapped_sequences)
    profiles = {}
    ref_thr = params.thr_internal_refinement
    n_done = n

    for node_id in range(len(tree_list)):
        a, b = tree_list[node_id]
        if node_id < n:
            continue
        n_done += 1
        if n_done % 100 == 0:
            logger.progress(f"Computing alignment - "
                            f"{100.0 * n_done / (2 * n - 1):.1f}%"
                            f"    ({n_done} of {2 * n - 1})")
        for child in (a, b):
            if child < n and child not in profiles:
                profiles[child] = Profile.from_gapped_sequence(
                    gapped_sequences[child], params)
        prof1 = profiles.pop(a)
        prof2 = profiles.pop(b)

        if ref_thr and prof1.size() + prof2.size() > ref_thr:
            if 2 < prof1.size() <= ref_thr:
                prof1 = refine_alignment(prof1, params, backend=params.backend)
            if 2 < prof2.size() <= ref_thr:
                prof2 = refine_alignment(prof2, params, backend=params.backend)

        dest = Profile(params)
        align_into(dest, prof1, prof2, backend=params.backend)
        profiles[node_id] = dest

    if not profiles:
        # single leaf
        return Profile.from_gapped_sequence(gapped_sequences[0], params)
    assert len(profiles) == 1
    return profiles.popitem()[1]


def _compute_alignment_batched(params, gapped_sequences, tree_list):
    """Ready-queue schedule (reference CProfileQueue, queues.cpp:27-124):
    a merge becomes ready the moment both children resolve; ready merges
    are taken deepest first, the device-worthy ones (split_ready) run as
    batches of up to FAMSA_TORCH_MAX_BATCH merges per device DP launch,
    or alone on the wide-merge DP when few are ready (split_wide), and
    the rest run on the native host DP (a small thread pool: the native
    DP releases the GIL).  Every device chunk of a ready set is
    dispatched before the first is resolved, and the host merges run
    while they are in flight; device merges take the resident route
    (ops/dp_resident.py): a side that a previous device merge produced is
    read from the device (Profile.dev_counters moves into the dispatch),
    only paths come back, and each result's merged counters stay on the
    device for its parent.  Caterpillar runs of at least CHAIN_MIN_LEN
    merges (each merges the previous one's profile with one leaf) take
    the chain route instead when their start is popped (run_chain).  On
    a "cols" mesh a caller set, the ready merges that
    parallel/mesh.py:cols_mesh accepts run alone, their columns sharded
    (split_sharded, through align_into)."""
    from .ops import dp_chain, dp_torch, dp_wide

    max_batch = int(os.environ.get("FAMSA_TORCH_MAX_BATCH", "16"))
    n = len(gapped_sequences)
    ref_thr = params.thr_internal_refinement

    # reference progress line (msa.cpp:412-424): computed profiles out of
    # 2n-1 (leaves + merges), every 100, at -vv
    n_prog = [n]

    def _tick():
        n_prog[0] += 1
        if n_prog[0] % 100 == 0 or n_prog[0] == 2 * n - 1:
            logger.progress(f"Computing alignment - "
                            f"{100.0 * n_prog[0] / (2 * n - 1):.1f}%"
                            f"    ({n_prog[0]} of {2 * n - 1})")

    children = {}
    n_pending = {}
    done = {}
    for node_id in range(n, len(tree_list)):
        a, b = tree_list[node_id]
        children[node_id] = (a, b)
        n_pending[node_id] = (a >= n) + (b >= n)

    parent_of = {}
    for node_id, (a, b) in children.items():
        parent_of[a] = node_id
        parent_of[b] = node_id

    # deepest-first priority (reference CProfileQueue, queues.cpp:27-40):
    # finishing one subtree before starting the next bounds the live
    # profile frontier
    depth = {}
    for node_id in range(len(tree_list) - 1, n - 1, -1):
        d = depth.get(node_id, 0)
        a, b = children[node_id]
        if a >= n:
            depth[a] = d + 1
        if b >= n:
            depth[b] = d + 1
    heap = [(-depth.get(v, 0), v) for v in children if n_pending[v] == 0]
    heapq.heapify(heap)

    def get_profile(child):
        if child < n:
            return Profile.from_gapped_sequence(gapped_sequences[child], params)
        return done.pop(child)

    def take_dev(p):
        """The resident counters of a side, moved into its dispatch."""
        dev, p.dev_counters = p.dev_counters, None
        return dev

    def release(node_id):
        parent = parent_of.get(node_id)
        if parent is not None:
            n_pending[parent] -= 1
            if n_pending[parent] == 0:
                heapq.heappush(heap, (-depth.get(parent, 0), parent))

    def finish(node_id, dest):
        done[node_id] = dest
        release(node_id)
        _tick()

    chain_by_start = {}
    if ref_thr == 0 and dp_chain.knob("CHAIN") == 1:
        chain_by_start = find_chain_runs(
            children, parent_of, n, [gs.size for gs in gapped_sequences],
            dp_chain.CHAIN_W1P, dp_chain.knob("CHAIN_MIN_LEN"))

    def run_chain(run):
        """One caterpillar run (famsa_tpu/pipeline.py:406-533 _run_chain):
        its merges on the native host DP while the chain is narrower than
        CHAIN_MIN_W2, then in device-resident chunks of CHAIN_K merges,
        two in flight; the run's inner merges release nothing, the last
        completed one is released (on an abort the rest of the run goes
        back to the other routes from there)."""
        ch = kernels.CHAIN
        ch["runs"] += 1
        v0, leaf0 = run[0]
        a0, b0 = children[v0]
        start_id = a0 if b0 == leaf0 else b0
        chain_prof = get_profile(start_id)
        if chain_prof.counters is None:
            chain_prof.calculate_counters_scores()
        idx, last_v = 0, None
        min_w2 = dp_chain.knob("CHAIN_MIN_W2")
        while idx < len(run) and chain_prof.width < min_w2:
            v, leaf = run[idx]
            lp = get_profile(leaf)
            pair = (lp, chain_prof) if children[v][0] == leaf \
                else (chain_prof, lp)
            chain_prof = align_into(Profile(params), *pair, backend="numpy")
            last_v = v
            idx += 1
            ch["prefix"] += 1
            _tick()
        if idx < len(run):
            k = dp_chain.knob("CHAIN_K")
            margin = dp_chain.knob("CHAIN_MARGIN")
            state = dp_chain.ChainState(dp_chain.buffers(
                params.device, k, dp_chain.CHAIN_W1P), chain_prof)
            todo = deque((v, get_profile(leaf)) for v, leaf in run[idx:])
            inflight = deque()          # (chunk [(v, leaf)], pending, cap)
            aborted = False

            def resolve_one():
                nonlocal chain_prof, last_v
                chunk, pend, cap = inflight.popleft()
                results = pend.resolve()
                built, overflow = 0, False
                for (v, lp), res in zip(chunk, results):
                    if lp.counters is None:
                        lp.calculate_counters_scores()
                    dest = Profile(params)
                    construct_profile(dest, lp, chain_prof, res)
                    chain_prof, last_v = dest, v
                    built += 1
                    ch["merges"] += 1
                    _tick()
                    if dest.width > cap:
                        overflow = True
                        break
                if not overflow and built < len(chunk):
                    raise RuntimeError("a chain chunk stopped before an "
                                       "overflow")
                if overflow:
                    # the chain on the card is poisoned past the overflow:
                    # requeue every merge not built, in order, and seed
                    # again from the last host profile
                    redo = chunk[built:]
                    while inflight:
                        redo.extend(inflight.popleft()[0])
                    todo.extendleft(reversed(redo))
                    state.dirty = True
                    ch["overflows"] += 1
                state.w_host = chain_prof.width

            while todo or inflight:
                if todo and len(inflight) < 2:
                    cap = dp_chain.cap_for(state.w_host
                                           + margin * (len(inflight) + 1))
                    if cap is None:
                        if inflight:
                            resolve_one()
                            continue
                        aborted = True
                        ch["aborts"] += 1
                        break
                    if state.dirty:
                        state.seed(params, chain_prof,
                                   dev=take_dev(chain_prof))
                    chunk = [todo.popleft()
                             for _ in range(min(len(todo), k))]
                    inflight.append((chunk, dp_chain.dispatch_chain_chunk(
                        params, state, [lp for _, lp in chunk], cap), cap))
                    continue
                resolve_one()
            if not aborted and not state.dirty and last_v == run[-1][0]:
                # the post-chain profile keeps its counters on the card
                # (after an overflow on the run's last merge it has none)
                chain_prof.dev_counters = state.final_ref(chain_prof.width)
        if last_v is None:
            # nothing merged (the start already too wide): v0 takes the
            # other routes
            done[start_id] = chain_prof
            heapq.heappush(heap, (-depth.get(v0, 0), v0))
        else:
            done[last_v] = chain_prof
            release(last_v)

    chunk_nodes = max_batch * 4
    n_workers = min(os.cpu_count() or 1, 8)
    host_pool = ThreadPoolExecutor(max_workers=n_workers) \
        if n_workers > 1 else None
    try:
        while heap:
            batch_nodes = [heapq.heappop(heap)[1]
                           for _ in range(min(len(heap), chunk_nodes))]
            if chain_by_start:
                rest = []
                for node_id in batch_nodes:
                    run = chain_by_start.pop(node_id, None)
                    if run is None:
                        rest.append(node_id)
                    else:
                        run_chain(run)
                batch_nodes = rest
            ready = []
            host = []
            for node_id in batch_nodes:
                a, b = children[node_id]
                prof1 = get_profile(a)
                prof2 = get_profile(b)
                if ref_thr and prof1.size() + prof2.size() > ref_thr:
                    if 2 < prof1.size() <= ref_thr:
                        prof1 = refine_alignment(prof1, params,
                                                 backend=params.backend)
                    if 2 < prof2.size() <= ref_thr:
                        prof2 = refine_alignment(prof2, params,
                                                 backend=params.backend)
                if prof1.counters is None:
                    prof1.calculate_counters_scores()
                if prof2.counters is None:
                    prof2.calculate_counters_scores()
                (ready if prof1.size() + prof2.size() > 2
                 else host).append((node_id, prof1, prof2))
            # merges that shard their columns over the "cols" mesh a
            # caller set run alone, through align_into
            # (famsa_tpu/pipeline.py:580-594, 617-625)
            sharded, ready = split_sharded(ready, params.device)
            device, host_prof = split_ready(ready)
            host += host_prof
            wide, device = split_wide(device, max_batch)

            # one K3 launch per wide merge, one K2 launch per chunk, all
            # dispatched before the host merges run and the first resolves
            pending = [([m], dp_wide.dp_profile_torch_wide_paths_async(
                params, m[1], m[2], take_dev(m[1]), take_dev(m[2]),
                want_merged=True)) for m in wide]
            for k0 in range(0, len(device), max_batch):
                chunk = device[k0:k0 + max_batch]
                pending.append((chunk, dp_torch.dp_profile_torch_paths_async(
                    params, [(p1, p2) for _, p1, p2 in chunk],
                    dev_pairs=[(take_dev(p1), take_dev(p2))
                               for _, p1, p2 in chunk],
                    want_merged=True)))

            if len(host) > 1 and host_pool is not None:
                futs = [(node_id, host_pool.submit(
                    align_into, Profile(params), p1, p2, backend="numpy"))
                    for node_id, p1, p2 in host]
                for node_id, fut in futs:
                    finish(node_id, fut.result())
            else:
                for node_id, p1, p2 in host:
                    finish(node_id, align_into(Profile(params), p1, p2,
                                               backend="numpy"))

            for node_id, p1, p2 in sharded:
                finish(node_id, align_into(Profile(params), p1, p2,
                                           backend=params.backend))

            for chunk, pend in pending:
                for (node_id, p1, p2), res in zip(chunk, pend.resolve()):
                    dest = Profile(params)
                    construct_profile(dest, p1, p2, res)
                    dest.dev_counters = res.merged_dev
                    finish(node_id, dest)
    finally:
        if host_pool is not None:
            host_pool.shutdown()
    assert len(done) == 1
    return done.popitem()[1]


def find_chain_runs(children, parent_of, n, leaf_sizes, w1p, min_len):
    """The caterpillar runs of a guide tree (famsa_tpu/pipeline.py:
    386-404): maximal sequences of merges [(node, leaf)] in which each
    merges the previous one's profile with one leaf of at most w1p
    symbols; returns {first node: run} for the runs of at least min_len
    merges.  children: {node: (a, b)}, nodes n.. ; leaf_sizes: each
    leaf's length."""
    runs_by_tail = {}
    for v in sorted(children):
        a, b = children[v]
        if (a < n) == (b < n):
            continue                      # leaf-leaf or internal pair
        leaf, internal = (a, b) if a < n else (b, a)
        if leaf_sizes[leaf] > w1p:
            continue
        if internal in runs_by_tail and parent_of.get(internal) == v:
            run = runs_by_tail.pop(internal)
        else:
            run = []
        run.append((v, leaf))
        runs_by_tail[v] = run
    return {run[0][0]: run for run in runs_by_tail.values()
            if len(run) >= min_len}


# ----------------------------------------------------------------------
class MSAResult:
    def __init__(self):
        self.alignment = None      # list[GappedSequence] in input order
        self.tree = None
        self.statistics = Statistics()


def compute_msa(params, sequences):
    """Full pipeline (msa.cpp:470-672). `sequences` is a list of Sequence
    in input order; consumed. Returns MSAResult."""
    result = MSAResult()
    params.adjust(len(sequences))

    tree = GuideTree()

    if params.export_distances:
        # input order, every sequence padded to the longest; no sort, no
        # dedup (msa.cpp's distance export)
        max_len = max(s.length for s in sequences)
        for s in sequences:
            s.resize(max_len, UNKNOWN_SYMBOL)
        export_distances(params, sequences)
        return result

    t_sort = StopWatch()
    t_sort.start()
    logger.verbose("Sorting sequences...", end="")
    sequences = sort_and_extend(sequences)
    t_sort.stop()
    logger.verbose(" [OK]")
    original2mapped = list(range(len(sequences)))

    dups = 0
    if not params.keep_duplicates:
        mapped_seqs = remove_duplicates(sequences, original2mapped)
        dups = len(sequences) - len(mapped_seqs)
        logger.verbose(f"Duplicate removal... {len(mapped_seqs)}/{len(sequences)} "
                       "sequences retained.")
    else:
        mapped_seqs = list(sequences)

    if len(mapped_seqs) == 1:
        final = [GappedSequence.from_sequence(s) for s in sequences]
        result.alignment = final
        return result

    for i, s in enumerate(mapped_seqs):
        s.sequence_no = i

    t_tree = StopWatch()
    t_tree.start()
    if params.gt_method == P.GT_IMPORTED:
        # Newick import works in sorted-sequence space (msa.cpp:564-567)
        logger.verbose(f"Importing guide tree from: {params.guide_tree_in_file}")
        tree.load_newick(params.guide_tree_in_file, [s.id for s in sequences])
        tree.to_unique(original2mapped, len(mapped_seqs))
    else:
        logger.verbose("Computing guide tree...", end="")
        build_guide_tree(params, mapped_seqs, tree)
        logger.verbose(" [OK]")
    t_tree.stop()

    # shrink sequences back to true length (msa.cpp:574)
    for s in sequences:
        s.resize(s.length, UNKNOWN_SYMBOL)

    result.tree = tree

    if params.export_tree:
        # tree store works in sorted-sequence space (msa.cpp:578-586)
        t_store = StopWatch()
        t_store.start()
        tree.from_unique(original2mapped)
        tree.save_newick(params.output_file_name, [s.id for s in sequences])
        t_store.stop()
        result.statistics.put("time.tree_store", t_store.elapsed)
        result.statistics.put("time.sort", t_sort.elapsed)
        result.statistics.put("time.tree_build", t_tree.elapsed)
        return result

    # gapped conversion (sorted order)
    gapped_sequences = [GappedSequence.from_sequence(s) for s in sequences]
    mapped_gapped = [None] * len(mapped_seqs)
    for i, gs in enumerate(gapped_sequences):
        if mapped_gapped[original2mapped[i]] is None:
            mapped_gapped[original2mapped[i]] = gs

    t_align = StopWatch()
    t_align.start()
    logger.verbose("Computing alignment...", end="")
    final_profile = compute_alignment(params, mapped_gapped, tree.raw())
    drain_gap_queue()          # deferred member gap applications
    t_align.stop()
    logger.verbose("[OK]")

    t_refine = StopWatch()
    t_refine.start()
    logger.verbose("Computing refinement...", end="")
    final_profile = refine_alignment(final_profile, params, backend=params.backend)
    t_refine.stop()
    logger.verbose("[OK]")

    if final_profile.size() != len(mapped_gapped):
        raise RuntimeError("Error: incomplete guide tree - report a bug")

    # order unique alignment by mapped id
    ordered_unique = [None] * len(final_profile.data)
    for gs in final_profile.data:
        ordered_unique[gs.sequence_no] = gs

    # final input-order alignment with duplicates restored (msa.cpp:626-650)
    ordered = [None] * len(gapped_sequences)
    for i, current in enumerate(gapped_sequences):
        representative = ordered_unique[original2mapped[i]]
        if current.original_no == representative.original_no:
            ordered[current.original_no] = representative
        else:
            dup = representative.copy()
            dup.id = current.id
            dup.original_no = current.original_no
            ordered[current.original_no] = dup

    result.alignment = ordered
    st = result.statistics
    if params.very_verbose_mode:
        sackin = tree.calculate_sackin_index()
        st.put("guide_tree.sackin", sackin)
        st.put("guide_tree.sackin_norm", sackin / float(len(gapped_sequences)))
    st.put("input.n_duplicates", dups)
    st.put("time.sort", t_sort.elapsed)
    st.put("time.tree_build", t_tree.elapsed)
    st.put("time.tree_store", 0.0)
    st.put("time.alignment", t_align.elapsed)
    st.put("time.refinement", t_refine.elapsed)
    return result


# ----------------------------------------------------------------------
def align_profiles(params, records1, records2):
    """Profile-profile mode (msa.cpp:675-718, famsa.cpp:73-101)."""
    from .core.sequence import encode_gapped

    prof1 = Profile(params)
    prof2 = Profile(params)
    for k, (rid, rseq) in enumerate(records1):
        prof1.append_raw_sequence(encode_gapped(rid, rseq, k))
    for k, (rid, rseq) in enumerate(records2):
        prof2.append_raw_sequence(encode_gapped(rid, rseq, len(records1) + k))

    prof1.calculate_counters_scores()
    prof2.calculate_counters_scores()

    final = Profile(params)
    align_into(final, prof1, prof2, backend=params.backend)
    drain_gap_queue()
    final = refine_alignment(final, params, backend=params.backend)
    return final.data
