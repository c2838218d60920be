"""Constants carried across from the reference package.

The system has no weights; what the beam scan needs besides its inputs
is two constant tables, reproduced here bit-for-bit:

- the phred -> weight table (the exact float32 expression
  frag.phred_weight uses, so device-reconstructed weights equal
  host weights);
- the dedup fingerprint constants, drawn from the same seeded numpy
  stream as floria_tpu/kernels/beam.py `_hash_consts_np`.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .frag import phred_weight

NUM_FINGERPRINTS = 2
HASH_SEED = 0xF10E1A


def phred_table() -> np.ndarray:
    """[256] float32 weights indexed by phred qual (index 0 -> 0.0)."""
    return phred_weight(np.arange(256, dtype=np.uint8))


def dedup_hash_consts(A: int, S: int, P: int
                      ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """(hs, gs): NUM_FINGERPRINTS uint32 [A, S] site constants and
    NUM_FINGERPRINTS odd uint32 [P] per-part mixers."""
    rng = np.random.default_rng(HASH_SEED)
    hs = [rng.integers(0, 1 << 32, (A, S), dtype=np.uint32)
          for _ in range(NUM_FINGERPRINTS)]
    gs = [rng.integers(0, 1 << 32, P, dtype=np.uint32) | np.uint32(1)
          for _ in range(NUM_FINGERPRINTS)]
    return hs, gs


def from_reference(hs, gs, phred, device) -> Tuple[torch.Tensor,
                                                    torch.Tensor,
                                                    torch.Tensor]:
    """The reference package's constants (numpy arrays) as the port's
    tensors on `device`: hs -> int64 [F, A, S], gs -> int64 [F, P] (the
    uint32 values, held in int64 so wrapping arithmetic is emulated with
    `& 0xFFFFFFFF`), phred -> float32 [256]."""
    h = torch.from_numpy(np.stack(hs).astype(np.int64)).to(device)
    g = torch.from_numpy(np.stack(gs).astype(np.int64)).to(device)
    p = torch.from_numpy(np.asarray(phred, np.float32)).to(device)
    return h, g, p
