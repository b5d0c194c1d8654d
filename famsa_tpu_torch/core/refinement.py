"""Iterative refinement (port of FAMSA src/msa_refinement.cpp).

The column-split heuristic, the mt19937(5489) draw sequence, the guided
re-alignment and the accept-if-not-worse rule are replicated exactly."""

import numpy as np

from ..utils.mt19937 import MT19937
from .aligner import align_into
from .defs import GAP
from .profile import Profile


def _refine_random(rnd, profile, dest_prof_id):
    for _ in range(len(profile.data)):
        dest_prof_id.append(rnd() % 2)
    if dest_prof_id.count(0) == 0 or dest_prof_id.count(1) == 0:
        idx = rnd() % len(dest_prof_id)
        dest_prof_id[idx] = 0 if dest_prof_id[idx] else 1


def _split_columns(profile):
    """The columns that a split may cut, in the order msa_refinement.cpp
    sorts them (:31-46): every column 1..size with x = min(gaps, card -
    gaps) > 0, by (x, column id).  One numpy pass; the order stays valid
    until the profile changes."""
    size = profile.data[0].gapped_size
    card = len(profile.data)
    stats = profile.get_gap_stats()[1:size + 1]
    x = np.minimum(stats, card - stats)
    cols = np.flatnonzero(x > 0)
    return cols[np.argsort(x[cols], kind="stable")] + 1


def _refine_most_empty_and_full_column(rnd, profile, columns):
    """msa_refinement.cpp:21-66 on the profile's _split_columns; returns
    dest_prof_id."""
    dest_prof_id = []
    if not len(columns):
        _refine_random(rnd, profile, dest_prof_id)
        return dest_prof_id

    col_id = int(columns[rnd() % len(columns)])
    first_prof_id, second_prof_id = 0, 1
    if profile.data[0].get_symbol(col_id) == GAP:
        first_prof_id, second_prof_id = second_prof_id, first_prof_id
    for gs in profile.data:
        if gs.get_symbol(col_id) == GAP:
            dest_prof_id.append(first_prof_id)
        else:
            dest_prof_id.append(second_prof_id)
    return dest_prof_id


def refine_alignment(profile: Profile, params, backend="numpy"):
    """Returns the (possibly replaced) refined profile."""
    rnd = MT19937(5489)

    if params.refinement_mode == "off" or (
            params.refinement_mode == "auto" and profile.size() > params.thr_refinement):
        return profile

    n_ref = params.n_refinements
    n_seq = profile.size()
    if n_ref > 2 * n_seq:
        n_ref = 2 * n_seq
    if 0 < n_ref < 100 and n_seq < 100:
        n_ref = 100

    n_ref_succ = 0
    prev_total_score = profile.calculate_total_score()
    profile.data.sort(key=lambda g: g.id)

    old_dest_prof_ids = []
    columns = None

    i_ref = 0
    i_succ_ref = 0
    while i_succ_ref < n_ref and i_ref < 20 * n_ref:
        if columns is None:
            columns = _split_columns(profile)
        dest_prof_id = _refine_most_empty_and_full_column(rnd, profile,
                                                          columns)

        if dest_prof_id not in old_dest_prof_ids:
            profile1 = Profile(params)
            profile2 = Profile(params)
            for k, gs in enumerate(profile.data):
                if dest_prof_id[k]:
                    profile1.append_raw_sequence(gs)
                else:
                    profile2.append_raw_sequence(gs)

            _, column_mapping1 = profile1.condense()
            _, column_mapping2 = profile2.condense()
            profile1.optimize_gaps()
            profile2.optimize_gaps()

            prof = Profile(params)
            align_into(prof, profile1, profile2,
                       list(column_mapping1), list(column_mapping2), backend=backend)
            prof.data.sort(key=lambda g: g.id)

            if not prof.equals(profile):
                prof.calculate_total_score()
                if prof.total_score >= prev_total_score:
                    prev_total_score = prof.total_score
                    profile, prof = prof, profile
                    n_ref_succ += 1
                    old_dest_prof_ids.clear()
                    columns = None

            old_dest_prof_ids.append(dest_prof_id)
            i_succ_ref += 1
        i_ref += 1

    return profile
