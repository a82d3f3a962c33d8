"""Loss pieces of the self-supervised objective (counterpart of
`fusiondepth_tpu/ops/losses.py`; reference trainer.py:577-589): static-shape
masking by weighted means instead of boolean indexing."""

from __future__ import annotations

import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor,
                eps: float = 1.0) -> torch.Tensor:
    """Mean of x over the entries where mask is nonzero."""
    w = mask.to(x.dtype)
    return (x * w).sum() / torch.clamp(w.sum(), min=eps)


def si_loss(depth: torch.Tensor, ref_depth: torch.Tensor,
            threshold: float = 5.0, si_var: float = 0.3, min_d: float = 1.0,
            max_d: float = 80.0, scale: float = 0.1) -> torch.Tensor:
    """Scale-invariant log loss of depth against sparse ref_depth.

    Valid pixels: ref > min_d, depth in (min_d, max_d), |depth - ref| <
    threshold. loss = sqrt(mean(d^2) - si_var * mean(d)^2) * scale over
    them, d = log(depth) - log(ref); 0 when no pixel is valid. Callers
    apply the reference's metric factor (depth * 26) first."""
    valid = ((ref_depth > min_d) & (depth < max_d) & (depth > min_d)
             & (torch.abs(depth - ref_depth) < threshold))
    w = valid.to(depth.dtype)
    n = w.sum()
    one = torch.ones((), dtype=depth.dtype, device=depth.device)
    d = torch.log(torch.where(valid, depth, one)) - \
        torch.log(torch.where(valid, ref_depth, one))
    denom = torch.clamp(n, min=1.0)
    mean_d2 = (d * d * w).sum() / denom
    mean_d = (d * w).sum() / denom
    var = torch.clamp(mean_d2 - si_var * mean_d * mean_d, min=0.0)
    return torch.where(n > 0, torch.sqrt(var) * scale,
                       torch.zeros_like(var))
