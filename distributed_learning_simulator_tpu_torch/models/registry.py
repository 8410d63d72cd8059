"""Model registry + ModelContext (the port's ``models/registry.py``).

A :class:`ModelContext` bundles an ``nn.Module`` with functions over
parameter dicts (``init`` / ``apply`` / ``loss``), which are what the
engine and the session pass around.  ``apply`` runs the module through
``torch.func.functional_call``, so the same module serves the f32 master
parameters, a client's bf16 copy, or views into a flat vector.  Dropout
draws from the ``torch.Generator`` passed to ``apply``/``loss`` (one per
client and round, ``models/dropout.py::dropout_generator``), never from
torch's global RNG.  ``functional_call`` swaps the module's parameters for
the duration of a forward, so ``apply`` holds a lock: the threaded
executor runs forwards from several worker threads on one module.
"""

import dataclasses
import threading
from collections.abc import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.collection import DatasetCollection
from ..ml_type import MachineLearningPhase as Phase

global_model_factory: dict[str, Callable[..., "ModelContext"]] = {}


def register_model(*names: str):
    def deco(fn):
        for name in names:
            global_model_factory[name.lower()] = fn
        return fn

    return deco


@dataclasses.dataclass
class ModelContext:
    name: str
    module: nn.Module  # holds ``init_weights(generator)``; lives on ``device``
    num_classes: int
    device: torch.device
    compute_dtype: torch.dtype = torch.float32
    dataset_type: str = "vision"
    #: "softmax_ce" (classification) or "causal_lm" (next-token CE: the
    #: model returns [B, L, V] logits and the targets are the INPUT tokens
    #: shifted left; dataset labels are ignored)
    loss_type: str = "softmax_ce"
    pad_id: int = 0  # causal_lm: positions whose target is pad weigh 0
    _forward_lock: threading.RLock = dataclasses.field(
        default_factory=threading.RLock, repr=False, compare=False
    )

    def init(self, seed: int) -> dict[str, torch.Tensor]:
        """Fresh f32 parameters from ``seed`` (drawn on the CPU with a
        ``torch.Generator``, so a seed gives the same weights on any
        device).  Under :meth:`apply`'s lock: the draw writes the module's
        tensors in place, which a forward on another thread has bound."""
        with self._forward_lock:
            self.module.init_weights(torch.Generator().manual_seed(seed))
            return {k: v.detach().clone() for k, v in self.module.state_dict().items()}

    def exclusive(self):
        """The lock :meth:`apply` takes (reentrant), for work that uses
        the module past one forward: remat's backward binds the module's
        blocks again to recompute them."""
        return self._forward_lock

    def apply(
        self, params: Mapping[str, torch.Tensor], inputs, train: bool = False, generator=None
    ):
        with self._forward_lock:
            self.module.train(train)
            return torch.func.functional_call(
                self.module, dict(params), (inputs,), {"generator": generator}
            )

    def _cast_for_compute(self, tree):
        """Floating tensors in the compute dtype (the identity, without a
        copy, where they already are)."""
        if self.compute_dtype == torch.float32:
            return tree
        if isinstance(tree, torch.Tensor):
            return tree.to(self.compute_dtype) if tree.is_floating_point() else tree
        return {k: self._cast_for_compute(v) for k, v in tree.items()}

    def loss(self, params, batch: dict, train: bool = False, generator=None):
        """Masked mean softmax cross-entropy + accuracy counts.  ``batch`` =
        ``{"input", "target", "mask"}``; padded samples weigh 0.  Under
        ``causal_lm`` the counts are tokens: a position weighs 1 when its
        sample is real, it is not the last, and its target is not pad."""
        logits = self.apply(
            self._cast_for_compute(params),
            self._cast_for_compute(batch["input"]),
            train=train,
            generator=generator,
        )
        if self.loss_type == "causal_lm":
            targets, token_mask = causal_lm_targets(batch["input"], batch["mask"], self.pad_id)
            return masked_ce_loss(logits, targets, token_mask)
        return masked_ce_loss(logits, batch["target"], batch["mask"])


def causal_lm_targets(tokens: torch.Tensor, mask: torch.Tensor, pad_id: int):
    """Next-token targets (the last position wraps to a filler) and the
    f32 token mask, ``[B, L]`` each."""
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    not_last = torch.arange(tokens.shape[1], device=tokens.device)[None, :] < tokens.shape[1] - 1
    token_mask = mask.to(torch.float32)[:, None] * not_last * (targets != pad_id)
    return targets, token_mask


def masked_ce_loss(logits, targets, mask):
    """f32 ``log_softmax`` cross-entropy, masked mean, plus the summed
    per-sample terms the engine reduces."""
    mask = mask.to(torch.float32)
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    count = mask.sum()
    loss = (nll * mask).sum() / torch.clamp(count, min=1.0)
    correct = ((logits.argmax(dim=-1) == targets) * mask).sum()
    return loss, {"loss_sum": nll * mask, "correct": correct, "count": count}


def create_model_context(
    model_name: str,
    dataset_collection: DatasetCollection,
    device: torch.device,
    **model_kwargs,
) -> ModelContext:
    factory = global_model_factory.get(model_name.lower())
    if factory is None:
        raise NotImplementedError(
            f"model {model_name!r} is not ported yet; ported: {sorted(global_model_factory)}"
        )
    return factory(dataset_collection=dataset_collection, device=device, **model_kwargs)


def example_batch(dc: DatasetCollection) -> np.ndarray:
    phase = Phase.Training if dc.has_dataset(Phase.Training) else Phase.Test
    return dc.get_dataset(phase).inputs[:1]
