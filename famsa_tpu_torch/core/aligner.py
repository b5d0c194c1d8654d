"""Profile alignment dispatch (port of CProfile::Align, profile.cpp:244-305)."""

import os

import numpy as np

if os.environ.get("FAMSA_TORCH_FAST_CONSTRUCT", "1") == "1":
    from .construct_fast import construct_profile_fast as construct_profile
else:
    from .construct import construct_profile
from .dp_native import dp_profile, dp_seq_seq, row_ranges
from .profile import Profile

# With the torch backend a profile merge (or guided re-alignment) of at
# least FAMSA_TORCH_DP_MIN_CELLS DP cells runs on the device DP
# (ops/dp_torch.py, kernel K2 on CUDA); smaller ones, and every seq-seq
# merge, stay on the native host DP.  Default: 2^16 cells, where a lone
# merge on K2 first beats the host DP on an H100.  The threshold is per
# merge, not scaled by how many merges are ready together: replaying the
# main path's own merges (scripts/torch_dp_crossover.py), rules that send
# batched merges to the host thread pool saved DP time but made the
# alignment stage slower end to end (PERF.md).
DP_MIN_CELLS_DEFAULT = "65536"
# A device merge of at least FAMSA_TORCH_WIDE_MIN_CELLS cells that is
# ready in a group of fewer than WIDE_MAX_READY device merges, and every
# guided re-alignment of that size, runs alone on the wide-merge DP
# instead (ops/dp_wide.py, kernel K3: one merge over up to 8 SMs), when
# its profile2 fits K3.  Both set by measurement on an H100 (PERF.md):
# replayed one at a time, K3 beat K2 on every lone merge and guided
# re-alignment from 2^16 cells up, and K2 (one launch) beat K3 (one launch
# per merge) once two or more device merges were ready together.
WIDE_MIN_CELLS_DEFAULT = "65536"
WIDE_MAX_READY = 2


def device_dp_ok(profile1, profile2):
    """True when a profile merge of these operands goes to the device DP
    under the torch backend (the knob is read per call)."""
    from ..ops.dp_torch import MAX_W2
    min_cells = int(float(os.environ.get("FAMSA_TORCH_DP_MIN_CELLS",
                                         DP_MIN_CELLS_DEFAULT)))
    return (profile1.width * profile2.width >= min_cells
            and max(profile1.width, profile2.width) <= MAX_W2)


def wide_dp_ok(profile1, profile2):
    """True when a device merge of these operands, in align_into's order,
    may take the wide-merge DP (the knob is read per call)."""
    from ..ops.dp_wide import MAX_W2
    min_cells = int(float(os.environ.get("FAMSA_TORCH_WIDE_MIN_CELLS",
                                         WIDE_MIN_CELLS_DEFAULT)))
    return (profile1.width * profile2.width >= min_cells
            and profile2.width <= MAX_W2)


def order_operands(profile1, profile2):
    """The (first, second) operand order of a profile merge: the single
    sequence first for seq-prof, else the reference's swap rule
    (nnz1*w2 < nnz2*w1 keeps the order)."""
    n1, n2 = len(profile1.data), len(profile2.data)
    if n1 == 1:
        return profile1, profile2
    if n2 == 1:
        return profile2, profile1
    nnz1 = int(np.count_nonzero(profile1.counters))
    nnz2 = int(np.count_nonzero(profile2.counters))
    if nnz1 * profile2.width < nnz2 * profile1.width:
        return profile1, profile2
    return profile2, profile1


def split_ready(ready):
    """Routes the profile merges [(key, profile1, profile2)] that the
    scheduler has ready together: returns (device [(key, p1, p2)] in
    align_into's operand order, host [(key, profile1, profile2)] as
    given)."""
    device, host = [], []
    for key, prof1, prof2 in ready:
        p1, p2 = order_operands(prof1, prof2)
        if device_dp_ok(p1, p2):
            device.append((key, p1, p2))
        else:
            host.append((key, prof1, prof2))
    return device, host


def split_wide(device, max_batch):
    """Routes the device merges [(key, p1, p2)] (split_ready's) of one
    ready group: returns (wide, batched), the merges that run alone on
    the wide-merge DP (K3) and those left for K2 launches of up to
    max_batch merges.  When fewer than WIDE_MAX_READY merges would share
    a K2 launch (min(len(device), max_batch) < WIDE_MAX_READY), each merge
    that wide_dp_ok accepts goes wide."""
    if min(len(device), max_batch) >= WIDE_MAX_READY:
        return [], device
    wide, batched = [], []
    for m in device:
        (wide if wide_dp_ok(m[1], m[2]) else batched).append(m)
    return wide, batched


def split_sharded(ready, device):
    """Routes the profile merges [(key, profile1, profile2)] that the
    scheduler has ready together: returns (sharded, rest), both
    [(key, profile1, profile2)] as given, sharded those that
    parallel/mesh.py:cols_mesh shards over a mesh a caller set (in
    align_into's operand order); none without such a mesh."""
    from ..parallel.mesh import auto_mesh, cols_mesh
    if auto_mesh("cols", device) is None:
        return [], ready
    sharded, rest = [], []
    for m in ready:
        p1, p2 = order_operands(m[1], m[2])
        (sharded if cols_mesh(p1, p2, device) is not None
         else rest).append(m)
    return sharded, rest


def _dp_sharded(params, p1, p2, mesh, cm1=None, cm2=None):
    """One merge's DP with its columns sharded over `mesh`
    (parallel/dp_sharded.py), traced on the lead (K4): only its path
    comes back; guided when column mappings are given
    (famsa_tpu/core/aligner.py:40-58 and :101-116)."""
    from ..parallel.dp_sharded import dp_profile_sharded_paths
    band = None if cm1 is None else row_ranges(params, cm1, cm2)
    return dp_profile_sharded_paths(params, p1, p2, mesh, band=band)


def _dp_torch(params, p1, p2, cm1=None, cm2=None):
    """One merge on the device DP (K3 when wide_dp_ok accepts it, else
    K2), traced on the device (K4): only its path comes back, and no
    merged counters are built (famsa_tpu/core/aligner.py:72-91); guided
    when column mappings are given."""
    from ..ops import dp_torch, dp_wide
    band = None if cm1 is None else row_ranges(params, cm1, cm2)
    if wide_dp_ok(p1, p2):
        pend = dp_wide.dp_profile_torch_wide_paths_async(params, p1, p2,
                                                         band=band)
    else:
        pend = dp_torch.dp_profile_torch_paths_async(params, [(p1, p2)],
                                                     bands=[band])
    return pend.resolve()[0]


def align_into(dest: Profile, profile1: Profile, profile2: Profile,
               column_mapping1=None, column_mapping2=None, backend="numpy"):
    """Aligns profile1 and profile2; result stored in dest.  The children's
    data lists are consumed (moved)."""
    if not profile1.data or not profile2.data:
        raise ValueError("Profiles cannot be empty")
    if profile1.counters is None:
        profile1.calculate_counters_scores()
    if profile2.counters is None:
        profile2.calculate_counters_scores()

    n1, n2 = len(profile1.data), len(profile2.data)
    if n1 == 1 and n2 == 1:
        res = dp_seq_seq(dest.params, profile1, profile2)
        construct_profile(dest, profile1, profile2, res)
        return dest
    p1, p2 = order_operands(profile1, profile2)
    cm1, cm2 = column_mapping1, column_mapping2
    if p1 is not profile1:
        cm1, cm2 = cm2, cm1
    mesh = None
    if backend == "torch":
        from ..parallel.mesh import cols_mesh
        mesh = cols_mesh(p1, p2, dest.params.device)
    if mesh is not None:
        res = _dp_sharded(dest.params, p1, p2, mesh, cm1, cm2)
    elif backend == "torch" and device_dp_ok(p1, p2):
        res = _dp_torch(dest.params, p1, p2, cm1, cm2)
    else:
        res = dp_profile(dest.params, p1, p2, cm1, cm2)
    construct_profile(dest, p1, p2, res)
    return dest
