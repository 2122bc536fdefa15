"""Plain PyTorch helpers that the queries' references share.  Imports
nothing of the program."""

import torch


def pk_lookup(pk: torch.Tensor, probe: torch.Tensor):
    """(hit, row): for each probe key, whether the unique-key column `pk`
    holds it, and at which row."""
    order = torch.argsort(pk)
    s = pk[order]
    pos = torch.searchsorted(s, probe).clamp_(max=max(s.shape[0] - 1, 0))
    return s[pos] == probe, order[pos]
