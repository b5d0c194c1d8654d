"""Neighbor Joining guide tree.

Port of FAMSA src/tree/NeighborJoining.cpp: classic O(N^3) NJ over
a float32 matrix.  Sequential float32 accumulation order is preserved
(np.add.accumulate) so sums are bit-identical to the reference's loops.
"""

import numpy as np


def _seq_sum32(values):
    """Sequential float32 summation (C++ loop order)."""
    if len(values) == 0:
        return np.float32(0)
    return np.add.accumulate(values.astype(np.float32))[-1]


def nj_tree(dmat, n_seq, tree):
    """dmat: square float32 (modified in place)."""
    if n_seq == 1:
        return
    if n_seq == 2:
        tree.append((0, 1))
        return

    row_id = np.arange(n_seq, dtype=np.int64)
    node_id = np.arange(n_seq, dtype=np.int64)
    # initial sums: sequential over j ascending, skipping i (D[i,i]=0 so
    # including it does not change float32 accumulation)
    sums = np.empty(n_seq, dtype=np.float32)
    for i in range(n_seq):
        sums[i] = _seq_sum32(dmat[i])

    row_ids = list(row_id)
    node_ids = list(node_id)
    sum_list = list(sums)

    n_clusters = n_seq
    it = 0
    while n_clusters > 2:
        rids = np.array(row_ids, dtype=np.int64)
        s = np.array(sum_list, dtype=np.float32)
        dsub = dmat[np.ix_(rids, rids)]
        q = (np.float32(n_clusters - 2) * dsub - s[:, None]) - s[None, :]
        q = q.astype(np.float32)
        # scan order: i ascending, j in (i, n): mask lower incl diag
        qm = q.astype(np.float64)
        qm[np.tril_indices(n_clusters)] = np.inf
        flat = int(np.argmin(qm))
        min_i, min_j = divmod(flat, n_clusters)

        ri, rj = int(rids[min_i]), int(rids[min_j])
        dij = dmat[ri, rj]

        tree.append((int(node_ids[min_i]), int(node_ids[min_j])))

        node_ids[min_i] = n_seq + it
        new_sum = np.float32(0)

        ks = [k for k in range(n_clusters) if k != min_i and k != min_j]
        for k in ks:
            rk = int(rids[k])
            dik = dmat[ri, rk]
            djk = dmat[rj, rk]
            sum_list[k] = np.float32(sum_list[k] - (dik + djk))
            dik = np.float32((dik + djk - dij) / np.float32(2))
            sum_list[k] = np.float32(sum_list[k] + dik)
            new_sum = np.float32(new_sum + dik)
            dmat[ri, rk] = dik
            dmat[rk, ri] = dik
        sum_list[min_i] = new_sum

        del row_ids[min_j]
        del node_ids[min_j]
        del sum_list[min_j]
        n_clusters -= 1
        it += 1

    tree.append((int(node_ids[0]), int(node_ids[1])))
