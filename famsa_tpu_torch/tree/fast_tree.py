"""PartTree / MedoidTree divide-and-conquer guide-tree heuristic.

Port of FAMSA src/tree/FastTree.cpp.  On the torch backend every
distance set (the first distance row, the assignment pass and the CLARANS
sample matrix) runs on K1 through TorchDistanceBackend; on the numpy
backend they run through the native LCS batch kernel.  Seed selection,
CLARANS clustering and the recursive splice stay on host with the exact
reference RNG draws (mt19937 default seed for eval 0).  Top-level subtree builds run
concurrently on a thread pool on the numpy backend (the reference's
RegisteringQueue of depth-0 subtree tasks, FastTree.cpp:152-205):
node-id bases are precomputed from the subgroup sizes, so the spliced
tree is byte-identical to the sequential walk."""

import concurrent.futures

import numpy as np

from ..native import get_lib
from ..ops.distance import transform_distances
from ..ops.lcs import build_bit_masks
from ..utils.mt19937 import MT19937, partial_shuffle
from .clarans import clarans


def _hash_uint32(x):
    """std::hash<uint32_t> on libstdc++ is the identity."""
    return x & 0xFFFFFFFF


def _seq_sum32(values):
    if len(values) == 0:
        return np.float32(0)
    return np.add.accumulate(values.astype(np.float32))[-1]


def _lcs_batch(masks, q):
    """Native (ctypes, GIL-released) LCS of one reference's masks against
    every row of q."""
    lcs = np.empty(len(q), dtype=np.int64)
    if len(q):
        get_lib().lcs_batch(np.ascontiguousarray(masks), masks.shape[1],
                            q, q.shape[0], q.shape[1], lcs)
    return lcs


class FastTree:
    def __init__(self, measure, partial_generator, subtree_size, sample_size,
                 num_evaluations, threshold, use_clustering,
                 cluster_fraction, cluster_iters, seed_observer=None,
                 n_threads=1, backend_factory=None):
        self.n_threads = n_threads
        # backend_factory(sequences, dtype) -> distance backend: routes the
        # medoid-path distance vectors (seeds, assignment pass, CLARANS
        # sample matrix) through the device LCS kernel (reference drives
        # them through the shared batched engine, FastTree.cpp:302-436);
        # without one they run on the host-native kernel.
        self.backend_factory = backend_factory
        self.measure = measure
        self.partial_generator = partial_generator   # fn(seqs, tree_list)
        self.subtree_size = subtree_size
        self.sample_size = sample_size
        self.num_evaluations = num_evaluations
        self.threshold = threshold
        self.use_clustering = use_clustering
        self.cluster_fraction = cluster_fraction
        self.cluster_iters = cluster_iters
        self.seed_observer = seed_observer

    # ------------------------------------------------------------------
    def _make_be(self, sequences):
        if self.backend_factory is None:
            return None
        return self.backend_factory(sequences, np.float32)

    def _dist_vector(self, ref, sequences, count, dtype=np.float32):
        masks = build_bit_masks(ref.data, ref.data_size)
        lmax = max(s.data_size for s in sequences[:count]) if count else 0
        q = np.full((count, lmax), 22, dtype=np.int8)
        for k in range(count):
            q[k, :len(sequences[k].data)] = sequences[k].data
        lcs = _lcs_batch(masks, q)
        lens = np.array([s.length for s in sequences[:count]], dtype=np.int64)
        return transform_distances(self.measure, lcs, int(ref.length), lens, dtype)

    def _dist_matrix(self, samples, dtype=np.float32):
        n = len(samples)
        be = self._make_be(samples)
        if be is not None:
            # full rows on device; exactly symmetric (LCS and both
            # transforms are symmetric in (len1, len2), and equal inputs
            # give bit-equal float32) with a 0.0 diagonal like the host
            return be.rows_batch(np.arange(n)).astype(dtype)
        d = np.zeros((n, n), dtype=dtype)
        for i in range(n):
            row = self._dist_vector(samples[i], samples, i, dtype)
            d[i, :i] = row
            d[:i, i] = row
        return d

    # ------------------------------------------------------------------
    def run(self, sequences, tree):
        local_tree = []
        self._do_step(sequences, local_tree, len(tree), 0)
        tree.extend(local_tree)

    def _do_step(self, sequences, tree, previous_top, depth):
        n_seqs = len(sequences)
        over = ((not self.use_clustering and n_seqs > self.subtree_size)
                or (self.use_clustering and n_seqs > self.threshold))
        if over:
            best_cost = np.finfo(np.float32).max
            best = None
            for ev in range(self.num_evaluations):
                cost, n_seeds, seed_ids, assignments = self._make_evaluation(sequences, ev)
                if cost < best_cost:
                    best_cost = cost
                    best = (n_seeds, seed_ids, assignments)
            n_seeds, seed_ids, assignments = best

            seeds = [sequences[k] for k in seed_ids]
            if self.seed_observer:
                self.seed_observer(seeds, depth)

            for k in range(n_seeds):
                assignments[seed_ids[k]] = k

            subgroups = [[] for _ in range(n_seeds)]
            for j in range(n_seqs):
                subgroups[assignments[j]].append(sequences[j])

            # node-id bases are a prefix sum of the subgroup merge counts,
            # so subtree builds are independent and can run concurrently
            # (reference depth-0 RegisteringQueue, FastTree.cpp:152-205)
            subroots = [-1] * n_seeds
            tops = [0] * n_seeds
            for k in range(n_seeds):
                tops[k] = previous_top
                if len(subgroups[k]) > 1:
                    previous_top += len(subgroups[k]) - 1
                    subroots[k] = previous_top - 1

            def build(k):
                local_tree = []
                if len(subgroups[k]) > 1:
                    self._do_step(subgroups[k], local_tree, tops[k], depth + 1)
                return local_tree

            big = sum(len(sg) > 1 for sg in subgroups)
            if depth == 0 and self.n_threads > 1 and big > 1:
                with concurrent.futures.ThreadPoolExecutor(
                        min(self.n_threads, big)) as ex:
                    for local_tree in ex.map(build, range(n_seeds)):
                        tree.extend(local_tree)
            else:
                for k in range(n_seeds):
                    tree.extend(build(k))

            local_tree = []
            self.partial_generator(seeds, local_tree)
            # correct node identifiers (FastTree.cpp:229-239)
            fixed = []
            for node_id in range(n_seeds - 1):
                a, b = local_tree[node_id]
                if a < n_seeds:
                    a = subroots[a] if len(subgroups[a]) > 1 else seeds[a].sequence_no
                else:
                    a = a + previous_top - n_seeds
                if b < n_seeds:
                    b = subroots[b] if len(subgroups[b]) > 1 else seeds[b].sequence_no
                else:
                    b = b + previous_top - n_seeds
                fixed.append((a, b))
            tree.extend(fixed)
        else:
            local_tree = []
            self.partial_generator(sequences, local_tree)
            if previous_top > n_seqs:
                fixed = []
                for node_id in range(n_seqs - 1):
                    a, b = local_tree[node_id]
                    a = sequences[a].sequence_no if a < n_seqs else a + previous_top - n_seqs
                    b = sequences[b].sequence_no if b < n_seqs else b + previous_top - n_seqs
                    fixed.append((a, b))
                tree.extend(fixed)
            else:
                tree.extend(local_tree)

    # ------------------------------------------------------------------
    def _make_evaluation(self, sequences, eval_num):
        """FastTree.cpp:270-331."""
        n_seqs = len(sequences)
        seed = 5489 if eval_num == 0 else _hash_uint32(eval_num)
        be = self._make_be(sequences)

        if not self.use_clustering:
            n_seeds, seed_ids, dist_row = self._random_seeds(
                sequences, self.subtree_size, be)
        else:
            n_seeds, seed_ids, dist_row = self._cluster_seeds(
                sequences, self.subtree_size, self.sample_size, seed, be)

        assignments = np.zeros(n_seqs, dtype=np.int64)
        if be is not None:
            # assignment pass batched through the device kernel
            # (reference FastTree.cpp:302-330); chunked so the [R, N]
            # block stays modest at multi-million-sequence scale
            for k0 in range(1, n_seeds, 32):
                ids = seed_ids[k0:min(k0 + 32, n_seeds)]
                rows = be.rows_batch(np.asarray(ids, dtype=np.int64))
                for off in range(len(ids)):
                    current = rows[off]
                    upd = current < dist_row
                    dist_row[upd] = current[upd]
                    assignments[upd] = k0 + off
        else:
            for k in range(1, n_seeds):
                current = self._dist_vector(
                    sequences[seed_ids[k]], sequences, n_seqs)
                upd = current < dist_row
                dist_row[upd] = current[upd]
                assignments[upd] = k

        cost = _seq_sum32(dist_row)
        return cost, n_seeds, list(seed_ids), assignments

    def _random_seeds(self, sequences, n_seeds, be=None):
        """PartTree seed pick (FastTree.cpp:334-362)."""
        n_seqs = len(sequences)
        dist_row = (be.row(0) if be is not None
                    else self._dist_vector(sequences[0], sequences, n_seqs))
        mt = MT19937()
        random_ids = list(range(n_seqs))
        furthest = 1 + int(np.argmax(dist_row[1:]))
        random_ids[1], random_ids[furthest] = random_ids[furthest], random_ids[1]
        partial_shuffle(random_ids, 2, n_seeds, n_seqs, mt)
        seed_ids = sorted(random_ids[:n_seeds])
        return n_seeds, seed_ids, dist_row

    def _cluster_seeds(self, sequences, n_seeds, n_samples, seed, be=None):
        """MedoidTree seed pick (FastTree.cpp:365-436)."""
        n_seqs = len(sequences)
        dist_row = (be.row(0) if be is not None
                    else self._dist_vector(sequences[0], sequences, n_seqs))

        if n_samples >= n_seqs:
            n_samples = n_seqs
            samples = sequences
            sample_ids = None
        else:
            mt = MT19937(seed)
            random_ids = list(range(n_seqs))
            partial_shuffle(random_ids, 1, n_samples, n_seqs, mt)
            sample_ids = sorted(random_ids[:n_samples])
            samples = [sequences[j] for j in sample_ids]

        dmat = self._dist_matrix(samples)
        seed_ids = np.zeros(n_seeds, dtype=np.int64)
        clarans(dmat, n_samples, n_seeds, 1, seed_ids,
                self.cluster_fraction, self.cluster_iters)

        seed_ids = [int(s) for s in seed_ids]
        if sample_ids is not None:
            seed_ids = [sample_ids[s] for s in seed_ids]
        return n_seeds, seed_ids, dist_row
