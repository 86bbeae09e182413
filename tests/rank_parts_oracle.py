"""The oracle that tests hold ``PPOUpdate.rank_parts`` to."""
from typing import List

import torch


def rank_minibatches(update, mb_indices: torch.Tensor) -> List[torch.Tensor]:
    """``update``'s rank's part of each global minibatch (a row of
    ``mb_indices``, global sample indices ``w * T + t``): the samples of its
    own workers, in the row's order, as rank-local indices; possibly none.
    Sized on the host: the variable-size reference of ``rank_parts``' fixed
    size, padded parts."""
    lo, hi = update._rank_span()
    mine = (mb_indices >= lo) & (mb_indices < hi)
    counts = mine.sum(dim=1).tolist()
    first = torch.argsort((~mine).to(torch.int32), dim=1, stable=True)
    local = torch.gather(mb_indices, 1, first) - lo
    return [local[j, :c] for j, c in enumerate(counts)]
