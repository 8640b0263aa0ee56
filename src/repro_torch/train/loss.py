"""Next-token cross-entropy (counterpart of ``repro/train/loss.py``)."""

from __future__ import annotations

import torch


def next_token_loss(logits: torch.Tensor, labels: torch.Tensor, *, shift: bool = True
                    ) -> torch.Tensor:
    """Mean CE of logits [B, S, V] against labels [B, S], in f32.

    shift=True: predict labels[:, t+1] from logits[:, t] (causal LM). The
    loss is logsumexp minus the target's logit. JAX picks the target with an
    iota compare and a sum over the vocabulary (zeros and the one logit), so
    its pick is the logit itself, exactly what ``gather`` reads."""
    if shift:
        logits = logits[:, :-1]
        labels = labels[:, 1:]
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = lf.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - tgt).mean()
