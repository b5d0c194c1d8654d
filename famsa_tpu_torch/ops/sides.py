"""The sides of a launch of the device DP route as descriptors: one
descriptor a merge side says where that side's counters lie, so that
stage 0 (K5, csrc/stage0.cu) and the merged counters (K6,
csrc/merged.cu) read them in place instead of from a copy.

A descriptor is DESC_WORDS int64 (csrc/sides.cuh):
  kind    SIDE_RESIDENT: int32 counter rows that a previous merge of the
          route left on the card (inside its MergedRef batch);
          SIDE_LEAF: the symbol bytes of an ungapped single-sequence
          profile, whose counter row r >= 1 is the one-hot of byte r - 1
          (row 0 is zero);
          SIDE_UPLOADED: int32 counter rows uploaded for this launch
  addr    the address of row 0 (SIDE_LEAF: of the byte of row 1)
  stride  elements from one row to the next (32 for counter rows, 1 for
          symbol bytes)
  width   the profile's width w: rows 0..w are its counters; a reader
          sees zero past them
  card    the profile's cardinality
A launch of B merges has 2B descriptors, side 1 of every merge, then
side 2 (the order of ops/dp_stage0.py:both_sides).

read_sides_plain is the plain PyTorch reader of the same descriptors: it
resolves each address inside the tensors the launch keeps alive
(LaunchSides.sources) and gives back the two sides as
ops/dp_resident.py:assemble_side would, [B, W+1, 32] int32 each, zero
past every profile's width.
"""

import torch

SIDE_RESIDENT, SIDE_LEAF, SIDE_UPLOADED = 0, 1, 2
DESC_WORDS = 8
D_KIND, D_ADDR, D_STRIDE, D_WIDTH, D_CARD = range(5)


class LaunchSides:
    """The 2B side descriptors of one launch: `desc` [2B, DESC_WORDS]
    int64 on the launch's device, `desc_h` the same on the host, and
    `sources`, the tensors the descriptors point into (kept alive until
    every reader of the launch is enqueued)."""
    __slots__ = ("desc", "desc_h", "sources")

    def __init__(self, desc, desc_h, sources):
        self.desc = desc
        self.desc_h = desc_h
        self.sources = sources

    @property
    def b(self):
        return self.desc_h.shape[0] // 2

    def widths(self):
        """(w1 [B], w2 [B]) host arrays."""
        w = self.desc_h[:, D_WIDTH]
        return w[:self.b], w[self.b:]


def _bytes_at(sources, addr):
    """The bytes of the source tensor that holds addr, from addr to its
    end (a 1-D uint8 view)."""
    for t in sources:
        base = t.data_ptr()
        nbytes = t.numel() * t.element_size()
        if base <= addr < base + nbytes:
            return t.reshape(-1).view(torch.uint8)[addr - base:]
    raise ValueError("a side descriptor points outside the launch's sources")


def read_side_plain(sides, k, rows):
    """[rows, 32] int32 counters of descriptor k (zero past its width)."""
    kind, addr, stride, w, _ = (int(v) for v in sides.desc_h[k, :5])
    raw = _bytes_at(sides.sources, addr)
    out = torch.zeros((rows, 32), dtype=torch.int32, device=raw.device)
    n = min(w, rows - 1)
    if kind == SIDE_LEAF:
        sym = raw[:n].long()
        out[1 + torch.arange(n, device=raw.device), sym] = 1
        return out
    if kind not in (SIDE_RESIDENT, SIDE_UPLOADED):
        raise ValueError(f"unknown side kind {kind}")
    if addr % 4:
        raise ValueError("counter rows must be 4-byte aligned")
    flat = raw[:raw.numel() // 4 * 4].view(torch.int32)
    idx = stride * torch.arange(n + 1, device=raw.device)[:, None] \
        + torch.arange(32, device=raw.device)
    out[:n + 1] = flat[idx]
    return out


def read_sides_plain(sides):
    """Plain PyTorch reader of a launch's descriptors: (c1 [B, W1+1, 32],
    c2 [B, W2+1, 32]) int32, W1 and W2 the widest side 1 and side 2, rows
    past each profile's width zero."""
    b = sides.b
    w1, w2 = sides.widths()
    out = []
    for half, wp in ((range(b), int(w1.max())), (range(b, 2 * b),
                                                 int(w2.max()))):
        out.append(torch.stack([read_side_plain(sides, k, wp + 1)
                                for k in half]))
    return tuple(out)
