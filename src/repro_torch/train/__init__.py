"""Training (counterpart of ``repro.train``): next-token loss, AdamW with a
warmup + cosine schedule, the train step with microbatch accumulation (on
one lane or over a lane mesh), and the compressed data-parallel step over
lanes."""

from repro_torch.train.loss import next_token_loss
from repro_torch.train.optimizer import (
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    warmup_cosine,
)
from repro_torch.train.step import (
    make_compressed_dp_train_step,
    make_loss_fn,
    make_train_step,
    value_and_grad,
)

__all__ = [
    "next_token_loss",
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "global_norm",
    "warmup_cosine",
    "make_loss_fn",
    "make_train_step",
    "make_compressed_dp_train_step",
    "value_and_grad",
]
