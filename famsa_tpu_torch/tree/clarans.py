"""CLARANS/FastPAM-style k-medoids (port of FAMSA src/tree/Clustering.cpp).

float32 arithmetic and the mt19937/det_uniform_int draw sequence are
replicated exactly; the assignment, per-candidate delta and swap loops run
natively (famsa_native.cpp: clarans_init, clarans_deltas,
clarans_apply_swap) in the reference's element-wise float order."""

import numpy as np

from ..native import get_lib
from ..utils.mt19937 import MT19937, det_uniform_int, partial_shuffle

_F32MAX = np.float32(np.finfo(np.float32).max)
MIN_MAX_NEIGHBOR = 250


def clarans(dmat, n_elems, n_medoids, n_fixed_medoids, medoids,
            explore_fraction, num_local):
    """dmat: square float32 distance matrix. medoids: int array out [n_medoids]."""
    n_swaps = (n_elems - n_medoids) * n_medoids
    if n_swaps < MIN_MAX_NEIGHBOR:
        max_neighbor = n_swaps
    else:
        max_neighbor = max(int(explore_fraction * n_swaps), MIN_MAX_NEIGHBOR)
    corrected_max_neighbor = max_neighbor // n_medoids

    lib = get_lib()

    candidate = list(range(n_elems))
    best_cost = _F32MAX
    best_candidate = None
    cur_candidate = None

    dists_nearest = np.zeros(n_elems, dtype=np.float32)
    dists_second = np.zeros(n_elems, dtype=np.float32)
    assign_nearest = np.zeros(n_elems, dtype=np.int64)
    assign_second = np.zeros(n_elems, dtype=np.int64)
    deltas = np.zeros(n_medoids, dtype=np.float32)

    gen_nodes = MT19937()
    gen_positions = MT19937()

    for _ in range(num_local):
        partial_shuffle(candidate, n_fixed_medoids, n_elems, n_elems, gen_nodes)
        cur_candidate = list(candidate)

        for mm in range(n_medoids):
            m = candidate[mm]
            dists_nearest[m] = 0
            dists_second[m] = -1
            assign_nearest[m] = -1
            assign_second[m] = -1

        cand_arr = np.array(candidate, dtype=np.int64)
        cur_cost = np.float32(lib.clarans_init(
            dmat, n_elems, n_medoids, cand_arr, dists_nearest,
            dists_second, assign_nearest, assign_second))

        step = 0
        while step < corrected_max_neighbor:
            xx = det_uniform_int(gen_positions, n_medoids, n_elems - 1)
            lib.clarans_deltas(dmat, n_elems, n_medoids, xx, cand_arr,
                               dists_nearest, dists_second,
                               assign_nearest, deltas)

            mm_new = n_fixed_medoids + int(np.argmin(
                deltas[n_fixed_medoids:n_medoids].astype(np.float64)))
            delta = deltas[mm_new]

            if delta < 0:
                # swaps cand_arr[mm_new] and cand_arr[xx] in place
                cur_cost = np.float32(lib.clarans_apply_swap(
                    dmat, n_elems, n_medoids, xx, mm_new, cand_arr,
                    dists_nearest, dists_second, assign_nearest,
                    assign_second, cur_cost))
                cur_candidate[mm_new], cur_candidate[xx] = (
                    cur_candidate[xx], cur_candidate[mm_new])
                step = 0

            step += 1
        candidate[:] = cand_arr.tolist()

        if cur_cost < best_cost:
            best_cost = cur_cost
            best_candidate = list(cur_candidate[:n_medoids])

    if best_candidate is not None:
        medoids[:n_medoids] = best_candidate
    return medoids
