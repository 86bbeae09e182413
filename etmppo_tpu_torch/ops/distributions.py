"""Multi-discrete categorical policy-head utilities
(counterpart of ``etmppo_tpu/ops/distributions.py``).

Per-branch logits are carried as a list; actions and log-probs are stacked on
a trailing branch axis.

Under data parallelism a rank samples its workers' rows of a batch of
``n_rows``: the uniforms are drawn for all ``n_rows`` and the rank keeps
``rows`` of them, so its actions are the ones one device would sample.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def log_prob(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """log P(action) for one branch. logits: (..., A), actions: (...) int."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, actions.long()[..., None])[..., 0]


def entropy(logits: torch.Tensor) -> torch.Tensor:
    """Entropy of one branch (as torch.distributions.Categorical.entropy)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -(logp.exp() * logp).sum(dim=-1)


def sample(logits: torch.Tensor, generator: torch.Generator,
           rows: Optional[slice] = None, n_rows: int = 0,
           margins: Optional[list] = None) -> torch.Tensor:
    """Samples one branch (..., A) -> (...) int32 by the Gumbel-max trick, with
    uniforms drawn from ``generator`` (on the logits' device). With ``rows``,
    ``logits`` are those rows of a batch of ``n_rows``, and the uniforms are
    drawn for the whole batch. Given a list ``margins``, appends the gap
    between the two largest perturbed logits (...): how near the draw came
    to a tie, which a float difference in the logits could tip."""
    if rows is None:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
    else:
        u = torch.rand((n_rows,) + tuple(logits.shape[1:]),
                       generator=generator, device=logits.device)[rows]
    u = u.clamp_(min=torch.finfo(u.dtype).tiny)
    perturbed = logits - torch.log(-torch.log(u))
    if margins is not None:
        top2 = perturbed.topk(2, dim=-1).values
        margins.append(top2[..., 0] - top2[..., 1])
    return torch.argmax(perturbed, dim=-1).to(torch.int32)


def sample_multi(branch_logits: Sequence[torch.Tensor],
                 generator: torch.Generator, rows: Optional[slice] = None,
                 n_rows: int = 0, margins: Optional[list] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Samples all branches (``rows``, ``n_rows`` and ``margins`` as for
    ``sample``); returns (actions, log_probs), each (..., n_branches)."""
    actions = torch.stack([sample(logits, generator, rows, n_rows, margins)
                           for logits in branch_logits], dim=-1)
    log_probs = torch.stack([log_prob(logits, actions[..., i])
                             for i, logits in enumerate(branch_logits)], dim=-1)
    return actions, log_probs


def log_probs_and_entropies(branch_logits: Sequence[torch.Tensor],
                            actions: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-branch log-probs of ``actions`` (..., n_branches) and the summed
    entropy (...,)."""
    lps = [log_prob(logits, actions[..., i])
           for i, logits in enumerate(branch_logits)]
    ents = [entropy(logits) for logits in branch_logits]
    return torch.stack(lps, dim=-1), torch.stack(ents, dim=-1).sum(dim=-1)
