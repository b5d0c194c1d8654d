"""Traceback of the profile DP on the device: the wrapper of the CUDA
kernel K4 (csrc/traceback.cu), its plain version and the readers
of its output buffer.

K4 walks the packed direction bytes that K2 (ops/dp_torch.py:dp_dirs) or
K3 (ops/dp_wide.py:dp_dirs_wide) leave on the card, with their per-row
finals and meta, and writes one buffer per launch (PATH_TRAILER bytes a
merge, then the paths):
  out[16 b : 16 b + 8]   int64 total of merge b
  out[16 b + 8 : + 12]   int32 path length n_b (-1: the walk left the
                         matrix, which a DP kernel's bytes never make it do)
  out[16 b + 12 : + 16]  int32 first channel (0 D, 1 H, 2 V)
  out[poff_b : poff_b + n_b]  the forward path, one code a step, where
                         poff_b = 16 B + sum_{c<b} (w1_c + w2_c); the
                         w1_b + w2_b - n_b bytes after it are zero.
Its contract is the native trace_path (core/dp_native.py:finish_path),
which the pipeline ran on the host before: path = finish_path(...).path,
total = finish_path(...).total.

K4 walks a window of each merge's direction bytes staged in shared
memory (csrc/traceback.cu); TB_WINDOW_BYTES and window_shape mirror the
kernel's, so that tests and chip_smoke.py can place cases on the
window's edges.  The plain version has no window: its result does not
depend on one.
"""

import math

import numpy as np
import torch

from .. import kernels

PATH_TRAILER = 16                   # bytes of a merge's total and length
# csrc/traceback.cu: the window's bytes of shared memory
TB_WINDOW_BYTES = 196608


def row_stride(cols):
    """Shared-memory bytes of a window row of `cols` columns (an odd
    multiple of 16 that holds the row's span from its aligned-down
    start)."""
    s = -(-cols // 16) * 16 + 16
    return s + 16 if (s // 16) % 2 == 0 else s


def window_shape(w1, w2):
    """(rows, cols) of the window K4 stages for a merge of w1 x w2: the
    whole matrix when it fits in TB_WINDOW_BYTES; else about
    sqrt(TB_WINDOW_BYTES (w2+1) / (w1+1)) columns and the rows that fit
    beside them, widened to the most columns that fit when every row
    fits.  The same integer arithmetic as csrc/traceback.cu:window_shape."""
    rows_all, cols_all = w1 + 1, w2 + 1
    if rows_all * row_stride(cols_all) <= TB_WINDOW_BYTES:
        return rows_all, cols_all
    c = min(max(math.isqrt(TB_WINDOW_BYTES * cols_all // rows_all), 1),
            cols_all)
    r = TB_WINDOW_BYTES // row_stride(c)
    if r >= rows_all:
        r = rows_all
        s = TB_WINDOW_BYTES // rows_all // 16 * 16
        if (s // 16) % 2 == 0:
            s -= 16
        c = min(s - 16, cols_all)
    return r, c


def path_offsets(meta_h):
    """[B] byte offsets of the merges' paths in K4's output, and its size,
    from the host meta [B, 4] (w1, w2, ...)."""
    lens = meta_h[:, 0] + meta_h[:, 1]
    b = len(lens)
    poff = PATH_TRAILER * b + np.concatenate([[0], np.cumsum(lens)[:-1]])
    return poff.astype(np.int64), int(PATH_TRAILER * b + lens.sum())


def trace_paths_plain(dirs, fin, meta):
    """Plain version of K4 on the same inputs and with the same output
    buffer (on dirs' device): the native walk, one merge and one step at a
    time, in Python over a host copy of the direction bytes."""
    meta_h = meta.cpu().numpy()
    poff, nbytes = path_offsets(meta_h)
    cells = memoryview(dirs.cpu().numpy())
    fin_h = fin.cpu()
    out = bytearray(nbytes)
    for m, (w1, w2, off, _) in enumerate(meta_h.tolist()):
        dhv = fin_h[m, w1 - 1].tolist()
        d, h, v = dhv
        dir0 = 0 if d >= h and d >= v else (1 if h > v else 2)
        i, j, dir_, steps, bad = w1, w2, dir0, [], False
        while i or j:
            cell = cells[off + i * (w2 + 1) + j]
            steps.append(dir_)
            i -= dir_ != 1
            j -= dir_ != 2
            dir_ = (cell >> (2 * dir_)) & 3
            if i < 0 or j < 0:
                bad = True
                break
        t = PATH_TRAILER * m
        out[t:t + 8] = dhv[dir0].to_bytes(8, "little", signed=True)
        out[t + 8:t + 12] = (0xFFFFFFFF if bad else len(steps)).to_bytes(
            4, "little")
        out[t + 12:t + 16] = dir0.to_bytes(4, "little")
        out[poff[m]:poff[m] + len(steps)] = bytes(reversed(steps))
    return torch.frombuffer(out, dtype=torch.uint8).to(dirs.device,
                                                        copy=True)


def trace_paths(dirs, fin, meta, meta_host=None):
    """Forward paths and totals of a batch of merges from their packed
    direction bytes (see the module docstring for the output).

    dirs [total] uint8, fin [B, ldf, 3] int64 and meta [B, 4] int64 as
    dp_dirs / dp_dirs_wide return and take them, on one device; meta_host:
    meta as a host array (read from meta when not given, which waits for
    the device).  Every merge needs w1, w2 >= 1.  CUDA tensors launch
    kernel K4; CPU tensors run trace_paths_plain."""
    if dirs.dtype != torch.uint8 or dirs.dim() != 1:
        raise TypeError("dirs must be a 1-D uint8 tensor")
    if fin.dtype != torch.int64 or meta.dtype != torch.int64:
        raise TypeError("fin and meta must be int64")
    if fin.dim() != 3 or fin.shape[2] != 3 or meta.dim() != 2 \
            or meta.shape != (fin.shape[0], 4):
        raise ValueError("fin must be [B, ldf, 3] and meta [B, 4]")
    if not (dirs.device == fin.device == meta.device):
        raise ValueError("inputs must be on one device")
    meta_h = (meta.cpu().numpy() if meta_host is None
              else np.asarray(meta_host, dtype=np.int64))
    if meta_h.shape != tuple(meta.shape):
        raise ValueError("meta_host does not match meta")
    w1, w2, off = meta_h[:, 0], meta_h[:, 1], meta_h[:, 2]
    if len(w1) and ((w1 < 1).any() or (w2 < 1).any()
                    or (w1 > fin.shape[1]).any()
                    or (off + (w1 + 1) * (w2 + 1) > dirs.numel()).any()):
        raise ValueError("K4 takes merges with w1, w2 >= 1 inside dirs "
                         "and fin")
    dev = dirs.device
    if dev.type == "cpu":
        return trace_paths_plain(dirs, fin, meta)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (dirs.is_contiguous() and fin.is_contiguous()
            and meta.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    b = meta.shape[0]
    out = torch.zeros(path_offsets(meta_h)[1], dtype=torch.uint8,
                      device=dev)
    if b == 0:
        return out
    lib = kernels.get("traceback")
    kernels.LAUNCHES["traceback"] += 1
    err = lib.trace_paths(dirs.data_ptr(), fin.data_ptr(), meta.data_ptr(),
                          b, fin.shape[1], out.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "trace_paths")
    return out


def read_paths(buf, meta_h):
    """[(path int64 numpy, total)] per merge from a K4 output buffer on the
    host (numpy uint8); raises for a walk that left its matrix."""
    b = meta_h.shape[0]
    poff, _ = path_offsets(meta_h)
    trailer = buf[:PATH_TRAILER * b].view(np.int64).reshape(b, 2)
    lens = (trailer[:, 1] & 0xFFFFFFFF).astype(np.int32)
    if (lens < 0).any():
        raise RuntimeError("K4: a traceback left its direction matrix")
    return [(buf[poff[k]:poff[k] + lens[k]].astype(np.int64),
             int(trailer[k, 0])) for k in range(b)]


def forward_paths(out, meta, smax):
    """[B, smax] int64 forward path codes on the device from a K4 output
    buffer on the device (sentinel 3 past each path), for the merged
    counters; meta [B, 4] on the device."""
    b = meta.shape[0]
    lens = meta[:, 0] + meta[:, 1]
    poff = PATH_TRAILER * b + torch.cumsum(lens, 0) - lens
    n = out[:PATH_TRAILER * b].view(torch.int64).reshape(b, 2)[:, 1] \
        & 0xFFFFFFFF
    k = torch.arange(smax, device=out.device)[None, :]
    codes = out[(poff[:, None] + k).clamp(max=out.numel() - 1)].long()
    return torch.where(k < n[:, None], codes, 3)
