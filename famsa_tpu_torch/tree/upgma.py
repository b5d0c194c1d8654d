"""UPGMA / UPGMA-modified (MAFFT average) guide trees.

Port of FAMSA src/tree/UPGMA.cpp (MUSCLE-derived O(N^2) UPGMA
with nearest-neighbor caching).  All distances are float32, matching the
reference's UPGMA_dist_t; vectorized per-merge updates preserve the exact
first-occurrence argmin scan semantics.
"""

import numpy as np

BIG_DIST = np.float32(1e29)
_DEAD = 0x7FFFFFFF


def upgma_distance_matrix(n_seq, row_fn):
    """Full square float32 matrix from per-row prefix distances."""
    d = np.zeros((n_seq, n_seq), dtype=np.float32)
    for i in range(n_seq):
        row = row_fn(i)         # distances to 0..i-1, float32
        d[i, :i] = row[:i]
        d[:i, i] = row[:i]
    return d


def upgma_tree(dmat, n_seq, tree, modified=False):
    """computeTree (UPGMA.cpp:112-295). dmat is modified in place."""
    if n_seq == 1:
        return
    min_dist = np.full(n_seq, BIG_DIST, dtype=np.float32)
    nearest = np.full(n_seq, _DEAD, dtype=np.int64)
    node_index = np.arange(n_seq, dtype=np.int64)
    alive = np.ones(n_seq, dtype=bool)

    lefts = np.empty(n_seq - 1, dtype=np.int64)
    rights = np.empty(n_seq - 1, dtype=np.int64)

    # initial row mins with exact scan order (strict <, rows ascending)
    for i in range(1, n_seq):
        row = dmat[i, :i]
        a = int(np.argmin(row))
        m = row[a]
        if m < min_dist[i]:
            min_dist[i] = m
            nearest[i] = a
        upd = row < min_dist[:i]
        min_dist[:i][upd] = row[upd]
        nearest[:i][upd] = i

    half = np.float32(0.5)
    c05 = np.float32(0.05)
    c09 = np.float32(0.9)

    for it in range(n_seq - 1):
        # find nearest pair: first j (ascending) with strict < improvement
        masked = np.where(alive, min_dist.astype(np.float64), np.inf)
        lmin = int(np.argmin(masked))
        rmin = int(nearest[lmin])

        js = np.nonzero(alive)[0]
        js = js[(js != lmin) & (js != rmin)]

        if len(js):
            dl = dmat[lmin, js]
            dr = dmat[rmin, js]
            if modified:
                dnew = c05 * (dl + dr) + c09 * np.minimum(dl, dr)
            else:
                dnew = (dl + dr) * half
            nearest[js[nearest[js] == rmin]] = lmin
            dmat[lmin, js] = dnew
            dmat[js, lmin] = dnew
            a = int(np.argmin(dnew))
            if dnew[a] < BIG_DIST:
                new_min = dnew[a]
                new_nn = int(js[a])
            else:
                new_min = BIG_DIST
                new_nn = _DEAD
        else:
            new_min = BIG_DIST
            new_nn = _DEAD

        lefts[it] = node_index[lmin]
        rights[it] = node_index[rmin]

        node_index[lmin] = n_seq + it
        nearest[lmin] = new_nn
        min_dist[lmin] = new_min
        alive[rmin] = False

    for i in range(n_seq - 1):
        tree.append((int(lefts[i]), int(rights[i])))
