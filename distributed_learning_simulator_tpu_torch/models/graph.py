"""Graph models (the port's ``models/graph.py``): TwoGCN, ThreeGCN,
SimpleGCN and OneGCN.

A GCN layer is the JAX package's ``gcn_conv``: the dense transform first,
then symmetric-normalised propagation over a static ``edge_index`` with an
optional per-edge mask and a self-loop term ``x / deg``.  The JAX package
sums with ``jax.ops.segment_sum``; here it is ``index_add_`` (plain
PyTorch, as the JAX package leaves it to XLA).

Every model has the JAX models' **stage API**: ``num_mp_layers`` counts
the message-passing layers and ``forward(inputs, stage=i, h=h)`` runs
stage ``i`` alone (stage 0 reads ``inputs["x"]``; the last stage ends in
logits), so a session can mix exchanged embeddings in before each stage
after the first.  ``forward(inputs)`` runs all stages.

**Slot-batched.**  The layers take any leading dims on the parameters,
the hidden state and the edge mask: called through ``functional_call``
with ``[S, ...]`` parameters and an ``[S, E]`` edge mask, one call runs
``S`` models at once (``x @ W_s`` for every slot in one product, one
gather of ``[S, E, H]`` messages and one scatter-add over ``dst``), as the
JAX session's ``vmap`` does.

Dropout (TwoGCN, ThreeGCN: 0.5, before every stage after the first) takes
its uniforms from ``draw(stage, shape)`` (the graph session's
``GraphRandom``); keep where the uniform is below ``1 - rate``, as flax's
``Dropout``.  The bits are not flax's.  Called without ``draw`` (the
threaded executor's trainer, through :meth:`~.registry.ModelContext.apply`),
the uniforms come from the ``generator`` passed in.

Submodules carry flax's names (``conv1``, ``conv2``, ``conv3``, ``out``;
each ``GCNLayer`` a bias-free ``Dense_0`` and its own ``bias``), so the
weight bridge (``models/convert.py``) maps them with its usual rules.
"""

from collections.abc import Callable

import torch
from torch import nn

from .layers import FlaxInit, init_flax_
from .registry import ModelContext, register_model

#: ``draw(stage, shape)`` -> uniforms in [0, 1) of ``shape``
Draw = Callable[[int, tuple[int, ...]], torch.Tensor]


def generator_draw(generator: torch.Generator) -> Draw:
    """``draw`` from a ``torch.Generator``: uniforms on its device."""

    def draw(stage: int, shape: tuple[int, ...]) -> torch.Tensor:
        return torch.rand(shape, generator=generator, device=generator.device)

    return draw


def gcn_conv(x, edge_index, edge_mask, weight, num_nodes: int) -> torch.Tensor:
    """``x @ weight.T`` propagated over the masked edges with symmetric
    normalisation and self-loops (the JAX ``gcn_conv``).  ``x`` is
    ``[..., N, in]``, ``weight`` ``[..., out, in]``, ``edge_mask`` None or
    ``[..., E]``; the leading dims broadcast."""
    x = torch.matmul(x, weight.transpose(-1, -2))
    src, dst = edge_index[0], edge_index[1]
    if edge_mask is None:
        ones = torch.ones(src.shape[0], dtype=torch.float32, device=x.device)
    else:
        ones = edge_mask.to(torch.float32)
    deg = ones.new_zeros(*ones.shape[:-1], num_nodes).index_add_(-1, dst, ones) + 1.0
    inv_sqrt = torch.rsqrt(deg)
    coeff = inv_sqrt.index_select(-1, src) * inv_sqrt.index_select(-1, dst) * ones
    messages = x.index_select(-2, src) * coeff[..., None]
    agg = messages.new_zeros(*messages.shape[:-2], num_nodes, x.shape[-1]).index_add_(-2, dst, messages)
    return agg + x * (1.0 / deg)[..., None]  # self-loop term


def _dense(h: torch.Tensor, linear: nn.Linear) -> torch.Tensor:
    """flax ``Dense`` with any leading dims on its parameters."""
    return torch.matmul(h, linear.weight.transpose(-1, -2)) + linear.bias.unsqueeze(-2)


def _dropout(h: torch.Tensor, rate: float, training: bool, stage: int, draw: Draw | None) -> torch.Tensor:
    if not training or rate == 0.0:
        return h
    if draw is None:
        raise ValueError("dropout in training needs a draw")
    keep_prob = 1.0 - rate
    keep = draw(stage, tuple(h.shape)) < keep_prob
    return torch.where(keep, h / keep_prob, torch.zeros((), dtype=h.dtype, device=h.device))


class GCNLayer(nn.Module):
    def __init__(self, in_features: int, features: int) -> None:
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features, bias=False)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, edge_index, edge_mask=None) -> torch.Tensor:
        out = gcn_conv(x, edge_index, edge_mask, self.Dense_0.weight, x.shape[-2])
        return out + self.bias.unsqueeze(-2)


class _StagedGCN(FlaxInit):
    """The stage plumbing: subclasses define ``num_mp_layers`` and
    ``mp_stage``; ``forward`` runs one stage or all of them."""

    num_mp_layers = 2

    def __init__(self, hidden: int) -> None:
        super().__init__()
        self.hidden = hidden

    def init_weights(self, generator: torch.Generator) -> None:
        init_flax_(self, generator)
        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, GCNLayer):
                    module.bias.zero_()

    def forward(self, inputs: dict, generator=None, stage: int | None = None, h=None, draw: Draw | None = None):
        if draw is None and generator is not None:
            draw = generator_draw(generator)
        if stage is not None:
            return self.mp_stage(stage, h, inputs, draw)
        h = self.mp_stage(0, None, inputs, draw)
        for i in range(1, self.num_mp_layers):
            h = self.mp_stage(i, h, inputs, draw)
        return h

    def mp_stage(self, i: int, h, inputs: dict, draw: Draw | None = None) -> torch.Tensor:
        raise NotImplementedError


class TwoGCN(_StagedGCN):
    def __init__(self, num_features: int, num_classes: int, hidden: int = 64, dropout_rate: float = 0.5) -> None:
        super().__init__(hidden)
        self.dropout_rate = dropout_rate
        self.conv1 = GCNLayer(num_features, hidden)
        self.conv2 = GCNLayer(hidden, num_classes)

    def mp_stage(self, i, h, inputs, draw=None):
        edge_index, edge_mask = inputs["edge_index"], inputs.get("edge_mask")
        if i == 0:
            return torch.relu(self.conv1(inputs["x"], edge_index, edge_mask))
        h = _dropout(h, self.dropout_rate, self.training, i, draw)
        return self.conv2(h, edge_index, edge_mask)


class ThreeGCN(_StagedGCN):
    """Three message-passing layers: exchanges fire before layers 2 and 3."""

    num_mp_layers = 3

    def __init__(self, num_features: int, num_classes: int, hidden: int = 64, dropout_rate: float = 0.5) -> None:
        super().__init__(hidden)
        self.dropout_rate = dropout_rate
        self.conv1 = GCNLayer(num_features, hidden)
        self.conv2 = GCNLayer(hidden, hidden)
        self.conv3 = GCNLayer(hidden, num_classes)

    def mp_stage(self, i, h, inputs, draw=None):
        edge_index, edge_mask = inputs["edge_index"], inputs.get("edge_mask")
        if i == 0:
            return torch.relu(self.conv1(inputs["x"], edge_index, edge_mask))
        h = _dropout(h, self.dropout_rate, self.training, i, draw)
        if i == 1:
            return torch.relu(self.conv2(h, edge_index, edge_mask))
        return self.conv3(h, edge_index, edge_mask)


class SimpleGCN(_StagedGCN):
    """One GCN layer and a dense head, the head kept as a stage."""

    def __init__(self, num_features: int, num_classes: int, hidden: int = 64) -> None:
        super().__init__(hidden)
        self.conv1 = GCNLayer(num_features, hidden)
        self.out = nn.Linear(hidden, num_classes)

    def mp_stage(self, i, h, inputs, draw=None):
        if i == 0:
            return torch.relu(self.conv1(inputs["x"], inputs["edge_index"], inputs.get("edge_mask")))
        return _dense(h, self.out)


class OneGCN(SimpleGCN):
    """``conf/fed_aas/dblp.yaml``'s OneGCN: one GCN layer and a dense head,
    which SimpleGCN already is."""


def _graph_context(name: str, cls, dataset_collection, device, hidden: int) -> ModelContext:
    module = cls(dataset_collection.input_shape[0], dataset_collection.num_classes, hidden)
    return ModelContext(
        name=name,
        module=module.to(device),
        num_classes=dataset_collection.num_classes,
        device=device,
        dataset_type="graph",
    )


@register_model("TwoGCN", "twogcn")
def _two_gcn(dataset_collection, device, hidden: int = 64, **kwargs) -> ModelContext:
    return _graph_context("TwoGCN", TwoGCN, dataset_collection, device, hidden)


@register_model("ThreeGCN", "threegcn")
def _three_gcn(dataset_collection, device, hidden: int = 64, **kwargs) -> ModelContext:
    return _graph_context("ThreeGCN", ThreeGCN, dataset_collection, device, hidden)


@register_model("SimpleGCN", "simplegcn")
def _simple_gcn(dataset_collection, device, hidden: int = 64, **kwargs) -> ModelContext:
    return _graph_context("SimpleGCN", SimpleGCN, dataset_collection, device, hidden)


@register_model("OneGCN", "onegcn")
def _one_gcn(dataset_collection, device, hidden: int = 64, **kwargs) -> ModelContext:
    return _graph_context("OneGCN", OneGCN, dataset_collection, device, hidden)
