"""Binomial-tail and log-sum-exp scoring primitives on f64 tensors.

Twins of floria_tpu/kernels/scores.py `binom_tail_jnp` and
`log_sum_exp_jnp` (utils_frags.rs:205-258). The only transcendental in
the beam scan; it feeds nothing but the prune threshold. Values may
differ from XLA's in the last bits (a different `log`), decisions do not
(see tests/test_torch_beam.py).
"""

from __future__ import annotations

import torch

_A_LO = 1e-7       # clamp for k/n == 0 (utils_frags.rs:228-231)
_A_HI = 0.9999999  # clamp for k/n == 1 (utils_frags.rs:224-227)


def binom_tail(n: torch.Tensor, k: torch.Tensor, p, div_factor: float
               ) -> torch.Tensor:
    """log P[Bin(n/div, p) >= k/div] large-deviation bound, elementwise,
    in the dtype of n (f64 on the beam path). p broadcasts against n."""
    n = torch.floor(n)
    k = torch.floor(k)
    safe_n = torch.where(n == 0, torch.ones_like(n), n)
    a = torch.clamp(k / safe_n, _A_LO, _A_HI)
    rel_ent = a * torch.log(a / p) + (1.0 - a) * torch.log(
        (1.0 - a) / (1.0 - p))
    rel_ent = torch.where(a < p, -rel_ent, rel_ent)
    return torch.where(n == 0, torch.zeros_like(n),
                       -n / div_factor * rel_ent)


def log_sum_exp(scores: torch.Tensor, dim: int = -1) -> torch.Tensor:
    m = scores.max(dim=dim, keepdim=True).values
    return (m + torch.log(torch.exp(scores - m).sum(
        dim=dim, keepdim=True))).squeeze(dim)
