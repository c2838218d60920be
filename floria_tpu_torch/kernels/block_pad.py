"""The block cache's padding (phase/local.py BlockDeviceCache): each shape
bucket's blocks are staged on the host as their own cells only, shipped
once, and padded to [B, r_pad, s_pad] on the device.

`stage` writes the members' live alleles, then their quals, back to back
into one host buffer (pinned for a card), and a table of each member's
(offset, num_reads, num_sites). `block_pad` turns them into the bucket's
padded int8 alleles (-1 where uncovered or padded) and uint8 quals (0
there) on the device: on a card one non_blocking copy of the buffer and
of the table, then the kernel `csrc/block_pad.cu` on the current stream,
so the host waits for nothing; on the CPU the plain version below.

The kernel replaces no TPU kernel: the JAX package pads its cache on the
host and uploads the padding too. Its note gives its bound and design.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import timing
from ..device import upload
from . import _build
from .blocktensor import BlockTensor

# Readable bytes the kernel needs past a staged buffer's 2 * cells: it
# loads the five aligned words around each 16 source bytes.
SLACK = 32
# Host threads that stage one bucket, and the fewest cells a thread. On
# an H100's host (8 cores) one thread staged `ecoli2`'s largest bucket
# (41.9 M cells) in 18.6 ms and three in 10.3-12.3; more did no better,
# as the host's memory bandwidth bounds the copy (one flat 84 MB copy
# took 14.3 ms), and a second thread slowed a bucket of 8.5 M cells.
STAGE_THREADS = 3
STAGE_CELLS = 1 << 23


def stage(blocks: Sequence[BlockTensor], pin: bool
          ) -> Tuple[torch.Tensor, np.ndarray, int]:
    """(staged, table, top) for one bucket's blocks, in order: `staged` a
    host uint8 tensor of 2 * cells bytes (pinned memory from PyTorch's
    caching allocator when `pin`), each block's alleles[:num_reads,
    :num_sites] row-major and back to back, then its quals likewise from
    byte `cells`; `table` [B, 3] int64 each block's (offset, num_reads,
    num_sites); `top` the largest allele staged, -1 when none is. Each
    byte is written once, straight into the buffer: by up to
    STAGE_THREADS host threads, one contiguous run of blocks each, for a
    bucket of more than STAGE_CELLS cells a thread (numpy's copies and
    max release the GIL)."""
    table = np.array([(0, bt.num_reads, bt.num_sites) for bt in blocks],
                     np.int64).reshape(-1, 3)
    sizes = table[:, 1] * table[:, 2]
    np.cumsum(sizes[:-1], out=table[1:, 0])
    cells = int(sizes.sum())
    staged = torch.empty(2 * cells, dtype=torch.uint8, pin_memory=pin)
    buf = staged.numpy()
    alleles, quals = buf[:cells].view(np.int8), buf[cells:]
    rows = table.tolist()

    def run(lo: int, hi: int) -> int:
        top = -1
        for bt, (o, r, s) in zip(blocks[lo:hi], rows[lo:hi]):
            dst = alleles[o:o + r * s].reshape(r, s)
            dst[...] = bt.alleles[:r, :s]
            # While the block's bytes are still in the core's cache.
            top = max(top, int(dst.max(initial=-1)))
            quals[o:o + r * s].reshape(r, s)[...] = bt.quals[:r, :s]
        return top

    n = min(STAGE_THREADS, len(blocks), max(1, cells // STAGE_CELLS))
    if n <= 1:
        return staged, table, run(0, len(blocks))
    cuts = [len(blocks) * k // n for k in range(n + 1)]
    with ThreadPoolExecutor(max_workers=n) as pool:
        tops = list(pool.map(run, cuts[:-1], cuts[1:]))
    return staged, table, max(tops)


def block_pad_plain(staged: torch.Tensor, table: np.ndarray, r_pad: int,
                    s_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: the padded (alleles int8, quals uint8)
    [B, r_pad, s_pad] of a staged bucket (`stage`), on `staged`'s
    device."""
    cells = staged.numel() // 2
    shape = (len(table), r_pad, s_pad)
    alleles = torch.full(shape, -1, dtype=torch.int8, device=staged.device)
    quals = torch.zeros(shape, dtype=torch.uint8, device=staged.device)
    for b, (o, r, s) in enumerate(np.asarray(table).tolist()):
        alleles[b, :r, :s] = staged[o:o + r * s].view(torch.int8).view(r, s)
        quals[b, :r, :s] = staged[cells + o:cells + o + r * s].view(r, s)
    return alleles, quals


def block_pad_cuda(staged: torch.Tensor, table: torch.Tensor, r_pad: int,
                   s_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's launch (csrc/block_pad.cu) on the card of `staged`, a
    uint8 tensor of 2 * cells + SLACK bytes laid out as `stage` lays out
    its first 2 * cells, with `table` [B, 3] int64 on the same card:
    the padded (alleles, quals) [B, r_pad, s_pad]. Checks types, shapes
    and alignment; the table's rows are checked on the host
    (`block_pad`)."""
    dev = staged.device
    if dev.type != "cuda":
        raise ValueError("block_pad_cuda needs CUDA tensors")
    B = table.shape[0]
    for name, x, dt, shape in (("staged", staged, torch.uint8, None),
                               ("table", table, torch.int64, (B, 3))):
        if x.device != dev or x.dtype != dt or not x.is_contiguous() or (
                shape is not None and tuple(x.shape) != shape) or (
                shape is None and x.dim() != 1):
            raise ValueError(
                f"block_pad_cuda: {name} must be a contiguous {dt} tensor "
                f"on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if staged.numel() < SLACK or (staged.numel() - SLACK) % 2:
        raise ValueError(f"block_pad_cuda: staged holds {staged.numel()} "
                         f"bytes, not 2 * cells + {SLACK}")
    if staged.data_ptr() % 4:
        raise ValueError("block_pad_cuda: staged must be 4-byte aligned "
                         "(the kernel loads 32-bit words)")
    if r_pad <= 0 or s_pad <= 0 or s_pad % 16:
        raise ValueError(f"block_pad_cuda: r_pad={r_pad} s_pad={s_pad}: "
                         "s_pad must be a positive multiple of 16")
    shape = (B, r_pad, s_pad)
    alleles = torch.empty(shape, dtype=torch.int8, device=dev)
    quals = torch.empty(shape, dtype=torch.uint8, device=dev)
    lib = _build.get_lib()
    ptr = ctypes.c_void_p
    with torch.cuda.device(dev):
        rc = lib.floria_block_pad(
            ptr(staged.data_ptr()), ptr(table.data_ptr()),
            (staged.numel() - SLACK) // 2, B, r_pad, s_pad,
            ptr(alleles.data_ptr()), ptr(quals.data_ptr()),
            ptr(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(rc, "block_pad")
    _build.count_launch("block_pad")
    return alleles, quals


def block_pad(staged: torch.Tensor, table: np.ndarray, r_pad: int,
              s_pad: int, device: torch.device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The padded (alleles int8, quals uint8) [B, r_pad, s_pad] of a
    staged bucket (`stage`) on `device`. On a card, `staged` must be
    pinned: it and `table` go over in non_blocking copies and the kernel
    pads on the current stream, with no host wait; on the CPU the plain
    version pads. Counts the staged bytes and the table's as
    `h2d_bytes`."""
    table = np.ascontiguousarray(table, np.int64)
    cells = staged.numel() // 2
    r, s = table[:, 1], table[:, 2]
    if (staged.numel() != 2 * cells or (table < 0).any()
            or (r > r_pad).any() or (s > s_pad).any()
            or (table[:, 0] + r * s > cells).any()):
        raise ValueError(f"block_pad: the table does not fit {r_pad} x "
                         f"{s_pad} cells and a staged buffer of "
                         f"{staged.numel()} bytes")
    if device.type != "cuda":
        timing.count("h2d_bytes", staged.numel() + table.nbytes)
        return block_pad_plain(staged, table, r_pad, s_pad)
    if not staged.is_pinned():
        raise ValueError("block_pad: a card's staged buffer must be in "
                         "pinned memory (stage(..., pin=True))")
    timing.count("h2d_bytes", staged.numel())
    buf = torch.empty(staged.numel() + SLACK, dtype=torch.uint8,
                      device=device)
    buf[:staged.numel()].copy_(staged, non_blocking=True)
    return block_pad_cuda(buf, upload(table, device), r_pad, s_pad)
