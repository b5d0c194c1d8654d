"""MSA profile: per-column symbol counters and precomputed column scores.

TPU-first layout: counters/scores are dense [width+1, 32] row-major arrays,
so CalculateScores is a counters @ SM matmul and the DP match-score matrix
is a counters1 @ scores2^T matmul (MXU-friendly).  Semantics mirror the
reference CProfile (FAMSA src/core/profile.{h,cpp}); pointers in
docstrings cite the corresponding reference code.
"""

import numpy as np

from .defs import (GAP, GAP_EXT, GAP_OPEN, GAP_TERM_EXT, GAP_TERM_OPEN,
                   NO_AMINOACIDS, NO_SYMBOLS, SCORE_DTYPE)
from .sequence import GappedSequence


def _runs_within(starts, ends, weights, lo, hi):
    """For each window of columns [lo[q], hi[q]] (0 <= hi[q]), the weight
    of the runs j that lie in it (starts[j] >= lo[q], ends[j] <= hi[q]).
    A merge-sort tree over the runs by descending start: the runs with
    start >= lo are a prefix, cut into aligned blocks of 2^k runs, one
    level k at a time, each block's runs sorted by end."""
    order = np.argsort(-starts, kind="stable")
    s, e, w = starts[order], ends[order], weights[order]
    m = np.searchsorted(-s, -lo, side="right")
    span = int(max(e.max(), hi.max(initial=0))) + 1
    pos = np.arange(len(s))
    out = np.zeros(len(lo), dtype=np.int64)
    k = 0
    while (m >> k).any():
        blk = pos >> k
        srt = np.lexsort((e, blk))
        key = blk[srt] * span + e[srt]
        cw = np.concatenate(([0], np.cumsum(w[srt])))
        q = np.flatnonzero((m >> k) & 1)
        b = (m[q] >> k) - 1
        at = np.searchsorted(key, b * span + hi[q], side="right")
        out[q] += cw[at] - cw[b << k]
        k += 1
    return out


class Profile:
    __slots__ = ("params", "data", "counters", "scores", "width",
                 "total_score", "dev_counters", "_dp_stats",
                 "_gap_ptrs", "_gap_sizes")

    def __init__(self, params):
        self.params = params
        self.data = []            # list[GappedSequence]
        self.counters = None      # int64 [width+1, 32]
        self.scores = None        # int64 [width+1, 32]
        self.width = 0
        self.total_score = 0
        # device-resident copy of `counters` (ops/dp_resident.py:
        # MergedRef), left by the device merge that built this profile
        # for its parent's merge; dropped whenever the host recomputes
        # `counters`
        self.dev_counters = None
        # magnitude-statistics cache for the DP dispatch bounds
        self._dp_stats = None
        # member n_gaps pointer/size arrays for the native batched gap
        # apply (core/construct_fast.py:_gap_ptr_cache)
        self._gap_ptrs = None
        self._gap_sizes = None

    @classmethod
    def from_gapped_sequence(cls, gs: GappedSequence, params):
        """Leaf profile (reference CProfile(const CGappedSequence&, ...))."""
        p = cls(params)
        p.append_raw_sequence(gs)
        p.calculate_counters_scores()
        return p

    def size(self):
        return len(self.data)

    def empty(self):
        return not self.data

    # ------------------------------------------------------------------
    def append_raw_sequence(self, gs: GappedSequence):
        """Append a copy without aligning (profile.cpp:329-357)."""
        w = gs.gapped_size
        if not self.data:
            self.width = w
        elif w != self.width:
            raise ValueError("profile width mismatch")
        self.data.append(gs.copy())

    # ------------------------------------------------------------------
    def calculate_counters_scores(self):
        """profile.cpp:220-235; vectorized over member sequences.  Drops
        the device-resident copy, which would be stale."""
        self.dev_counters = None
        if not self.data:
            return
        self.width = self.data[0].gapped_size
        w = self.width
        counters = np.zeros((w + 1, NO_SYMBOLS), dtype=np.int64)

        cols_parts = []
        syms_parts = []
        for gs in self.data:
            pos = gs.symbol_positions()          # [size] 1-based columns
            size = gs.size
            n_gaps = gs.n_gaps
            # symbols
            cols_parts.append(pos)
            syms_parts.append(gs.symbols.astype(np.int64))

            first_non_gap = int(n_gaps[0]) + 1
            last_non_gap = w - int(n_gaps[size])
            # terminal gaps at front (profile.cpp:113-119)
            if first_non_gap > 1:
                cols_parts.append(np.array([1], dtype=np.int64))
                syms_parts.append(np.array([GAP_TERM_OPEN], dtype=np.int64))
                if first_non_gap > 2:
                    cols_parts.append(np.arange(2, first_non_gap, dtype=np.int64))
                    syms_parts.append(np.full(first_non_gap - 2, GAP_TERM_EXT, dtype=np.int64))
            # terminal gaps at back (profile.cpp:122-128)
            if last_non_gap < w:
                cols_parts.append(np.array([last_non_gap + 1], dtype=np.int64))
                syms_parts.append(np.array([GAP_TERM_OPEN], dtype=np.int64))
                if w > last_non_gap + 1:
                    cols_parts.append(np.arange(last_non_gap + 2, w + 1, dtype=np.int64))
                    syms_parts.append(np.full(w - last_non_gap - 1, GAP_TERM_EXT, dtype=np.int64))
            # internal gap runs after symbols 1..size-1 (profile.cpp:136-154)
            run_idx = np.nonzero(n_gaps[1:size] > 0)[0] + 1    # i with n_gaps[i]>0
            if len(run_idx):
                starts = pos[run_idx - 1] + 1                  # col after symbol i
                cols_parts.append(starts)
                syms_parts.append(np.full(len(starts), GAP_OPEN, dtype=np.int64))
                lens = n_gaps[run_idx]
                ext_counts = lens - 1
                ext_total = int(ext_counts.sum())
                if ext_total:
                    # columns starts+1 .. starts+len-1 get GAP_EXT
                    # (segmented arange: repeat run base, add in-run offset)
                    base = np.repeat(starts + 1, ext_counts)
                    seg_start = np.repeat(np.cumsum(ext_counts) - ext_counts,
                                          ext_counts)
                    ext_cols = base + (np.arange(ext_total) - seg_start)
                    cols_parts.append(ext_cols)
                    syms_parts.append(np.full(ext_total, GAP_EXT, dtype=np.int64))

        cols = np.concatenate(cols_parts)
        syms = np.concatenate(syms_parts)
        np.add.at(counters, (cols, syms), 1)
        self.counters = counters
        self._calculate_scores()

    def _calculate_scores(self):
        """profile.cpp:162-217 as matmul + vector epilogues."""
        p = self.params
        w = self.width
        counters = self.counters
        scores = np.zeros((w + 1, NO_SYMBOLS), dtype=SCORE_DTYPE)
        prof_size = len(self.data)

        scores[0, GAP_OPEN] = prof_size * p.gap_open
        scores[0, GAP_EXT] = prof_size * p.gap_ext
        scores[0, GAP_TERM_EXT] = prof_size * p.gap_term_ext
        scores[0, GAP_TERM_OPEN] = prof_size * p.gap_term_open

        c = counters[1:]
        gap_cost = (c[:, GAP_OPEN] * p.gap_open + c[:, GAP_TERM_OPEN] * p.gap_term_open
                    + c[:, GAP_EXT] * p.gap_ext + c[:, GAP_TERM_EXT] * p.gap_term_ext)
        # symbol scores: counters[:, :24] @ SM  (SM symmetric)
        sym_scores = c[:, :NO_AMINOACIDS] @ p.score_matrix
        scores[1:, :NO_AMINOACIDS] = sym_scores + gap_cost[:, None]

        tot_n_sym = c[:, :NO_AMINOACIDS].sum(axis=1)
        scores[1:, GAP_OPEN] = tot_n_sym * p.gap_open
        scores[1:, GAP_TERM_OPEN] = tot_n_sym * p.gap_term_open
        scores[1:, GAP_EXT] = tot_n_sym * p.gap_ext
        scores[1:, GAP_TERM_EXT] = tot_n_sym * p.gap_term_ext
        self.scores = scores

    # ------------------------------------------------------------------
    def get_gap_stats(self):
        """stats[pos] = #gaps at column pos, pos in 0..width (profile.cpp:360-376)."""
        stats = np.full(self.width + 1, len(self.data), dtype=np.int64)
        for gs in self.data:
            stats[0] -= 1
            stats[gs.symbol_positions()] -= 1
        return stats

    def condense(self):
        """Remove all-gap columns (profile.cpp:380-432).

        Returns (changed, column_mapping) where column_mapping lists the kept
        old column ids (incl. 0) in increasing order."""
        if not self.data:
            return False, []
        self.width = self.data[0].gapped_size
        card = len(self.data)
        gap_stats = self.get_gap_stats()
        keep = np.ones(self.width + 1, dtype=bool)
        keep[1:] = gap_stats[1:] != card
        column_mapping = np.nonzero(keep)[0].astype(np.int64)
        changed = bool((~keep).any())
        if changed:
            # old col -> new col for kept columns
            colmap = np.cumsum(keep).astype(np.int64) - 1
            new_width = int(keep.sum()) - 1
            for gs in self.data:
                gs.remap_columns(colmap, new_width)
            self.width = new_width
        self.calculate_counters_scores()
        return changed, list(column_mapping)

    # ------------------------------------------------------------------
    def optimize_gaps(self):
        """Gap-column exchange heuristic (profile.cpp:436-689)."""
        NO_GAP, IS_GAP = 0, 1
        if not self.params.enable_gap_optimization:
            return False
        r = False
        width = self.width
        data = self.data
        data_size = len(data)

        # trans[pos][j] : IS_GAP unless sequence j has a symbol at column pos
        trans = np.full((width + 1, data_size), IS_GAP, dtype=np.int8)
        boundaries = np.ones(width + 1, dtype=bool)
        for j, gs in enumerate(data):
            pos = gs.symbol_positions()
            trans[pos, j] = NO_GAP
            no_follow = pos[gs.n_gaps[1:] == 0]
            boundaries[no_follow] = False

        exch_cols = [i for i in range(1, width) if boundaries[i]]
        if not exch_cols:
            return r

        max_possible_col_id = width
        T_LEFT, T_RIGHT, T_BOTH, T_BOTH_NE, T_BOTH_L, T_BOTH_R = 0, 1, 2, 3, 4, 5

        while exch_cols:
            curr = exch_cols.pop()
            if curr + 2 > max_possible_col_id:
                continue

            a = trans[curr].astype(bool)      # gap at curr
            b = trans[curr + 1].astype(bool)  # gap at curr+1
            exch_type = np.full(data_size, -1, dtype=np.int8)
            exch_type[a & b] = T_BOTH
            exch_type[a & ~b] = T_LEFT
            exch_type[~a & b] = T_RIGHT
            left_range = np.zeros(data_size, dtype=np.int64)
            right_range = np.zeros(data_size, dtype=np.int64)
            left_range[a] = 1
            right_range[b] = 1

            # max exchangeable region to the left (profile.cpp:535-561)
            left_side = 2
            while curr + 1 - left_side > 0:
                col = trans[curr + 1 - left_side].astype(bool)
                stop = False
                is_left = exch_type == T_LEFT
                is_both = exch_type == T_BOTH
                left_range[is_left & col] = left_side
                if (is_left & ~col).any():
                    stop = True
                left_range[is_both & col] = left_side
                exch_type[is_both & ~col] = T_BOTH_NE
                if stop:
                    break
                left_side += 1

            exch_type[exch_type == T_BOTH_NE] = T_BOTH
            # max exchangeable region to the right (profile.cpp:563-594)
            right_side = 2
            while curr + right_side < max_possible_col_id:
                col = trans[curr + right_side].astype(bool)
                stop = False
                is_right = exch_type == T_RIGHT
                is_both = exch_type == T_BOTH
                right_range[is_right & col] = right_side
                if (is_right & ~col).any():
                    stop = True
                right_range[is_both & col] = right_side
                exch_type[is_both & ~col] = T_BOTH_NE
                if stop:
                    break
                right_side += 1

            exch_type[exch_type == T_BOTH_NE] = T_BOTH

            # classify 'both' sequences (profile.cpp:596-613)
            is_both = exch_type == T_BOTH
            bad = is_both & (left_range < left_side - 1) & (right_range < right_side - 1)
            if bad.any():
                continue
            both_l = is_both & (left_range >= left_side - 1) & ~(right_range >= right_side - 1)
            both_r = is_both & ~(left_range >= left_side - 1)
            exch_type[both_l] = T_BOTH_L
            exch_type[both_r] = T_BOTH_R

            if curr - left_side <= 0 or curr + right_side >= width:
                continue

            left_col = curr - (left_side - 1)
            right_col = curr + right_side
            tl = trans[left_col].astype(bool)   # gap at left_col
            tr = trans[right_col].astype(bool)  # gap at right_col

            is_left = exch_type == T_LEFT
            is_right = exch_type == T_RIGHT
            balance = 0
            balance -= int((is_left & ~tl).sum())
            balance += int((is_left & ~tr).sum())
            balance -= int((is_right & ~tr).sum())
            balance += int((is_right & ~tl).sum())
            balance += int(((exch_type == T_BOTH_L) & ~tr).sum())
            balance += int(((exch_type == T_BOTH_R) & ~tl).sum())

            if balance < 0:
                move_left = is_left | (exch_type == T_BOTH_L)
                move_right = is_right | (exch_type == T_BOTH_R)
                # bulk gap edits: n repeated InsertGap(pos)/RemoveGap(pos)
                # land in the SAME gap run (insertion grows the run that
                # covers pos; removal shrinks a run that provably spans
                # past pos for all n edits here), so one insert_gaps/
                # remove_gaps call is exact - the reference loops singular
                # O(log n) DPS edits instead (profile.cpp:662-676)
                for j in np.nonzero(move_left)[0]:
                    gs = data[j]
                    gs.insert_gaps(right_col, left_side - 1)
                    gs.remove_gaps(left_col + 1, left_side - 1)
                for j in np.nonzero(move_right)[0]:
                    gs = data[j]
                    gs.remove_gaps(curr + 1, right_side - 1)
                    gs.insert_gaps(left_col + 1, right_side - 1)
                # NOTE: trans is intentionally left stale inside
                # (left_col, right_col]; like the reference, later iterations
                # only read columns < left_col (max_possible_col_id guard).
                max_possible_col_id = left_col
                r = True

        return r

    # ------------------------------------------------------------------
    def calculate_total_score(self):
        """Exact SP score incl. exact gap-open counting (profile.cpp:1368-1542)."""
        p = self.params
        if not p.enable_total_score_calculation:
            self.total_score = 0
            return 0

        width = self.width
        sm = p.score_matrix
        c = self.counters[1:, :NO_AMINOACIDS]

        # pairwise symbol score: sum_cols (c SM c^T - sum_d SM[d,d] c_d) / 2
        quad = np.einsum('is,st,it->', c, sm, c, optimize=True)
        diag = (c * np.diag(sm)[None, :]).sum()
        score = (int(quad) - int(diag)) // 2

        # estimate all gaps as extensions (profile.cpp:1406-1410)
        cg = self.counters[1:]
        n_gaps_col = cg[:, GAP_OPEN] + cg[:, GAP_EXT]
        n_gaps_term_col = cg[:, GAP_TERM_OPEN] + cg[:, GAP_TERM_EXT]
        n_symbols_col = len(self.data) - n_gaps_col - n_gaps_term_col
        n_gap_ext = int((n_symbols_col * n_gaps_col).sum())
        n_gap_term_ext = int((n_symbols_col * n_gaps_term_col).sum())

        # gap run multiplicity: multiplicity of each distinct (len, start)
        # run across member sequences (profile.cpp:1428-1452), vectorized:
        # the run at gap-slot j starts at gapped position 1 + j + sum(n_gaps[:j])
        keys = []
        for gs in self.data:
            n_gaps = gs.n_gaps
            idx = np.nonzero(n_gaps)[0]
            if len(idx):
                lens_r = n_gaps[idx]
                pos_r = 1 + idx + (np.cumsum(n_gaps) - n_gaps)[idx]
                keys.append(lens_r * (width + 2) + pos_r)
        if keys:
            all_keys, counts = np.unique(np.concatenate(keys), return_counts=True)
            run_len = (all_keys // (width + 2)).astype(np.int64)
            run_pos = (all_keys % (width + 2)).astype(np.int64)
        else:
            run_len = run_pos = counts = np.zeros(0, dtype=np.int64)

        # the runs within windows of columns (gap_ranges of
        # profile.cpp:1456-1501, a (width + 1)^2 table there; here only the
        # windows read, by _runs_within)
        size = len(self.data)
        n_gap_open = 0
        n_gap_term_open = 0
        if len(run_len):
            ln = run_len
            i0 = run_pos
            cur = counts
            end = i0 + ln - 1
            inner, left, right = ln > 2, end - 1 > 0, i0 + 1 <= width
            within = _runs_within(
                i0, end, cur,
                np.concatenate([i0[inner] + 1, np.ones(int(left.sum()),
                                                       dtype=np.int64),
                                i0[right] + 1]),
                np.concatenate([end[inner] - 1, end[left] - 1,
                                np.full(int(right.sum()), width,
                                        dtype=np.int64)]))
            a, b = int(inner.sum()), int(left.sum())
            n_inside = np.full(len(ln), int(cur.sum()), dtype=np.int64)
            n_inside[inner] += within[:a]
            n_inside[left] -= within[a:a + b]
            n_inside[right] -= within[a + b:]
            n_inside -= cur
            contrib = (size - cur - n_inside) * cur
            term = (i0 == 1) | (i0 + ln - 1 == width)
            n_gap_term_open = int(contrib[term].sum())
            n_gap_open = int(contrib[~term].sum())

        n_gap_ext -= n_gap_open
        n_gap_term_ext -= n_gap_term_open

        score += (n_gap_ext * p.gap_ext + n_gap_open * p.gap_open
                  + n_gap_term_ext * p.gap_term_ext + n_gap_term_open * p.gap_term_open)
        self.total_score = score
        return score

    # ------------------------------------------------------------------
    def equals(self, other):
        """profile.cpp:86-98 semantics (id/shape/gap-structure equality)."""
        if len(self.data) != len(other.data) or self.width != other.width:
            return False
        for a, b in zip(self.data, other.data):
            if (a.id != b.id or a.size != b.size
                    or not np.array_equal(a.n_gaps, b.n_gaps)
                    or not np.array_equal(a.symbols, b.symbols)):
                return False
        return True
