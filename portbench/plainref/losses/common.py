"""Shared loss helpers.

Counterpart of ``iou3dmatch_tpu/losses/common.py``: cross-entropy with
torch's per-element semantics and the reference's masked mean.

The reductions over the batch axis are written for a data group
(``parallel/``): while a step runs under ``shard_train_step`` each rank's
loss and metric is its share of the global one, so every denominator is
global: a data-dependent sum goes through ``all_reduce_sum`` (the
``+ 1e-6`` added once, to the global sum), and a count of rows is this
rank's times the ranks (every rank holds ``[L_r; U_r]`` of equal sizes).
Without an active group each helper is the plain expression.
"""
import torch
import torch.nn.functional as F


FAR_THRESHOLD = 0.6
NEAR_THRESHOLD = 0.3
GT_VOTE_FACTOR = 3
OBJECTNESS_CLS_WEIGHTS = (0.2, 0.8)


def one_hot(labels: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot rows; a compare against ``arange``, which, unlike
    ``F.one_hot``, never reads the labels back to the host."""
    return (labels[..., None] == torch.arange(n, device=labels.device)).float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, weights=None) -> torch.Tensor:
    """Per-element CE as ``nn.CrossEntropyLoss(reduction='none')``; with
    class ``weights`` each element is w[y] * nll, not normalised by the
    weights (callers divide by their own mask sums)."""
    nll = -F.log_softmax(logits, dim=-1).gather(-1, labels.long()[..., None])[..., 0]
    if weights is not None:
        # w[y] as a sum of compares: no copy of the weights to the device
        nll = nll * sum(w * (labels == i).to(nll.dtype) for i, w in enumerate(weights))
    return nll


def global_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / (sum over ranks of den + 1e-6): this rank's share of a ratio of
    global sums, ``num`` and ``den`` this rank's sums."""
    return num / (den + 1e-6)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum(x * mask) / (sum(mask) + 1e-6), the reference normalisation."""
    mask = mask.to(x.dtype)
    return global_ratio((x * mask).sum(), mask.sum())


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of every element of ``x``, over every rank's rows."""
    return x.mean()


def global_count(n: int) -> int:
    """A count of this rank's rows or elements -> the global batch's."""
    return n
