"""The row-sharded distance layer: the whole-tree MST-Prim and the
distance rows on a mesh (parallel/mesh.py).

The counterpart of famsa_tpu/parallel/dist_sharded.py.  The query axis
is split across the mesh's shards (Mesh.bounds: contiguous slices, no
pad rows), and with it the query mask table, so each shard computes its
slice of every LCS row.  The sharded programs of famsa_tpu depart
from `-backend numpy` twice, and the port follows numpy (ROADMAP C2):
 - every shard computes K1's exact LCS, and K9's FAMSA value for a
   flagged reference, where famsa_tpu's programs take the carry as
   V2 < V on 32-bit words (ops/lcs_jax.py:hyyro_step);
 - an LCS of 0 gives the host transform's nextafter(DBL_MAX, 0), where
   famsa_tpu's Prim program gives DBL_MAX.
"""

import numpy as np
import torch

from ..ops.lcs_torch import (BV32, TorchDistanceBackend, famsa_flags,
                             pad_sequences)
from ..ops.prim_torch import chunked_rounds, edges_to_tree
from .mesh import PrimShards, prim_round_sharded


def mst_prim_tree_sharded(sequences, tree, mesh, chunk=None):
    """Sharded drop-in for ops/prim_torch.py:mst_prim_tree_torch
    (indel075_div_lcs; the same dendrogram): every round is
    prim_round_sharded, and the edge buffer stays on the lead, coming to
    the host once a chunk of `chunk` rounds (FAMSA_TORCH_PRIM_CHUNK).
    Needs len(sequences) >= mesh.size."""
    n = len(sequences)
    if n == 1:
        return
    padded = pad_sequences(sequences, align=BV32)
    lengths = np.array([s.length for s in sequences], dtype=np.int64)
    flags = famsa_flags(padded)
    prim = PrimShards(mesh, padded, lengths, flags if flags.any() else None)
    lead = mesh.lead

    def run_chunk(k):
        edges = torch.empty((3, k), dtype=torch.int64, device=lead.device)
        for slot in range(k):
            prim_round_sharded(prim, edges, slot)
        return edges

    with lead.use():
        e1, e2, dneg = chunked_rounds(n, chunk, run_chunk)
    edges_to_tree(e1, e2, dneg, tree)


class ShardedDistanceBackend(TorchDistanceBackend):
    """Row-sharded TorchDistanceBackend (the counterpart of famsa_tpu's
    ShardedDistanceBackend, with the port's prefix sweep): for a block of
    references each shard of `mesh` computes its columns of the rows on
    its own stream, K1 for unflagged references and K9 for flagged ones;
    the blocks come to the host, where the distances are transformed.
    Needs len(sequences) >= mesh.size."""

    def __init__(self, sequences, measure, dtype, mesh, block_rows=256):
        if len(sequences) < mesh.size:
            raise ValueError(f"{len(sequences)} sequences cannot fill "
                             f"{mesh.size} shards")
        super().__init__(sequences, measure, dtype, device=mesh.lead.device,
                         block_rows=block_rows, mesh=mesh)
