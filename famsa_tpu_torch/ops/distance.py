"""Distance transforms and batched distance computation.

Transforms mirror FAMSA src/tree/AbstractTreeGenerator.hpp:28-122,
including the float-vs-double arithmetic split (SLINK/MST/dist-export use
double; UPGMA/NJ/FastTree use float) and the memoized pow(i, 0.75) table
(computed in double, cast to the target dtype).
"""

import numpy as np

from ..core.params import (DIST_INDEL075_DIV_LCS, DIST_INDEL_DIV_LCS, DIST_PID)
from .lcs import build_bit_masks, lcs_ref_vs_queries

_pow075_cache = {}


def _pow075_table(n, dtype):
    key = (dtype, )
    tab = _pow075_cache.get(key)
    if tab is None or len(tab) <= n:
        m = max(n + 1, 1024)
        tab = np.power(np.arange(m, dtype=np.float64), 0.75).astype(dtype)
        _pow075_cache[key] = tab
    return tab


def transform_distances(measure, lcs, len1, len2, dtype):
    """Vectorized distance transform; lcs/len arrays -> dtype array."""
    lcs = np.asarray(lcs, dtype=np.int64)
    len2 = np.asarray(len2, dtype=np.int64)
    big = np.nextafter(np.finfo(dtype).max, dtype(0)).astype(dtype)
    if measure == DIST_INDEL075_DIV_LCS:
        indel = (len1 + len2 - 2 * lcs)
        tab = _pow075_table(int(indel.max(initial=0)), dtype)
        num = tab[indel]
        with np.errstate(divide="ignore", invalid="ignore"):
            out = num / lcs.astype(dtype)
        return np.where(lcs == 0, big, out).astype(dtype)
    if measure == DIST_INDEL_DIV_LCS:
        indel = (len1 + len2 - 2 * lcs).astype(dtype)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = indel / lcs.astype(dtype)
        return np.where(lcs == 0, big, out).astype(dtype)
    if measure == DIST_PID:
        return (lcs.astype(dtype) / np.minimum(len1, len2).astype(dtype)).astype(dtype)
    raise ValueError(measure)


class DistanceBackend:
    """Computes LCS-based distance rows with the native host kernel.  The
    torch backend (ops/lcs_torch.py) is swapped in by the pipeline when
    enabled."""

    def __init__(self, sequences, measure, dtype):
        """sequences: list of objects with .data (padded i8) and .length."""
        self.sequences = sequences
        self.measure = measure
        self.dtype = dtype
        n = len(sequences)
        if n:
            lmax = max(s.data_size for s in sequences)
            self.padded = np.full((n, lmax), 22, dtype=np.int8)  # UNKNOWN pad
            for k, s in enumerate(sequences):
                self.padded[k, :len(s.data)] = s.data
            self.lengths = np.array([s.length for s in sequences], dtype=np.int64)

    def row(self, ref_idx, query_ids=None):
        """Distances from sequences[ref_idx] to query_ids (or all)."""
        ref = self.sequences[ref_idx]
        masks = build_bit_masks(ref.data, ref.data_size)
        if query_ids is None:
            q = self.padded
            ql = self.lengths
        else:
            q = np.ascontiguousarray(self.padded[query_ids])
            ql = self.lengths[query_ids]
        from ..native import get_lib
        lib = get_lib()
        if lib is not None and len(q):
            lcs = np.empty(len(q), dtype=np.int64)
            lib.lcs_batch(np.ascontiguousarray(masks), masks.shape[1],
                          q, q.shape[0], q.shape[1], lcs)
        else:
            lcs = lcs_ref_vs_queries(masks, q)
        return transform_distances(self.measure, lcs, int(ref.length), ql, self.dtype)

    def row_prefix(self, ref_idx, count):
        """Distances from sequences[ref_idx] to sequences[0:count]."""
        if count == 0:
            return np.zeros(0, dtype=self.dtype)
        return self.row(ref_idx, np.arange(count))

    def rows_batch(self, ref_ids, query_ids=None):
        """Distance rows for several reference ids at once ([R, N] or
        [R, len(query_ids)]).  Device backends override this to batch all
        rows into few dispatches (FastTree seeds/assignment/CLARANS)."""
        return np.stack([self.row(r, query_ids) for r in ref_ids])


def get_distance_backend(sequences, measure, dtype, backend="numpy",
                         device="cuda", mesh=None):
    """numpy -> DistanceBackend (native host LCS); torch ->
    TorchDistanceBackend (the LCS kernel on `device`, its plain PyTorch
    version on the CPU), or ShardedDistanceBackend with its rows sharded
    over `mesh` (parallel/mesh.py) when one is given."""
    if backend == "torch":
        if mesh is not None:
            from ..parallel.dist_sharded import ShardedDistanceBackend
            return ShardedDistanceBackend(sequences, measure, dtype, mesh)
        from .lcs_torch import TorchDistanceBackend
        return TorchDistanceBackend(sequences, measure, dtype, device=device)
    return DistanceBackend(sequences, measure, dtype)


def run_distances(params, measure):
    """(sequences, dtype) -> a run's distance backend for `measure`: K1 on
    `-backend torch` (on params.device, or its rows sharded over the mesh
    parallel/mesh.py:rows_mesh gives), the native host LCS on `-backend
    numpy`."""
    from ..parallel.mesh import rows_mesh
    return lambda seqs, dtype: get_distance_backend(
        seqs, measure, dtype, params.backend, device=params.device,
        mesh=rows_mesh(len(seqs), params.device)
        if params.backend == "torch" else None)
