"""SLINK single-linkage clustering with deterministic tie handling.

Port of FAMSA src/tree/SingleLinkage.cpp (SLINK_HANDLE_TIES variant):
lambda/dist entries are (distance, packed-id) pairs ordered by increasing
distance, DECREASING packed id on ties (SingleLinkage.h:18-38).  Distance
rows come from the distance backend (K1 on the torch backend); the O(N^2)
pointer update runs natively on the host (famsa_native.cpp:
slink_update_row).
"""

import numpy as np

from ..native import get_lib

_DMAX = np.finfo(np.float64).max


def slink_tree(n_seq, row_fn, tree):
    """row_fn(i) -> float64 distances from seq i to seqs 0..i-1.

    Appends n_seq-1 merge nodes to `tree`."""
    lib = get_lib()

    pi = np.zeros(n_seq, dtype=np.int64)
    lam_d = np.full(n_seq, _DMAX, dtype=np.float64)
    lam_p = np.zeros(n_seq, dtype=np.uint64)

    ids = np.arange(n_seq, dtype=np.uint64)

    for i in range(n_seq):
        pi[i] = i
        lam_d[i] = _DMAX
        lam_p[i] = 0

        dv_d = np.ascontiguousarray(row_fn(i)[:i], dtype=np.float64)
        # packed tie-break ids: ids_to_uint64(j, i) with j < i
        dv_p = (ids[:i] << np.uint64(32)) + np.uint64(i)
        lib.slink_update_row(i, dv_d, dv_p, pi, lam_d, lam_p)

    # dendrogram from stable-sorted lambda (SingleLinkage.cpp:166-189)
    elements = list(range(n_seq - 1))
    elements.sort(key=lambda x: (lam_d[x], -int(lam_p[x])))
    index = list(range(n_seq))
    for i in range(n_seq - 1):
        j = elements[i]
        nxt = int(pi[j])
        tree.append((index[j], index[nxt]))
        index[nxt] = n_seq + i
