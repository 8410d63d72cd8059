"""Vision models (the port's ``models/vision.py``): LeNet5, DenseNet-40 and
the ResNets of the JAX package's zoo.

GroupNorm, not BatchNorm, as in the JAX package (a client's state is its
parameters only).  The input is NHWC, as the datasets store it; the model
permutes it once to NCHW, and every layer runs in NCHW, so channels are
``dim=1`` (DenseNet's concatenation) and the spatial means are over dims
(2, 3).  flax's details kept: GroupNorm eps 1e-6 with contiguous channel
groups (:func:`_gn_groups`), and ``padding="SAME"`` padded by XLA's rule
from the input size (:class:`Conv`), which is asymmetric at stride 2 on
an even input.

Submodules carry flax's auto-names (``Conv_0``, ``GroupNorm_0``,
``DenseLayer_7``, ``ResNetBlock_3``, ``shortcut``, ``Dense_0`` ...), so a
``state_dict`` key is the JAX parameter path joined by ``.``
(``models/convert.py``).  Weights follow flax's initialisers
(``models/layers.py``).
"""

import torch
import torch.nn.functional as F
from torch import nn

from .layers import FlaxInit
from .registry import ModelContext, example_batch, register_model

_GN_EPS = 1e-6  # flax GroupNorm


def _gn_groups(channels: int) -> int:
    """Largest group count <= 8 that divides the channel count."""
    for groups in range(min(8, channels), 0, -1):
        if channels % groups == 0:
            return groups
    return 1


def _same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` on NCHW, ``padding`` "SAME" or "VALID"."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel: int,
        stride: int = 1,
        padding: str = "SAME",
        bias: bool = True,
    ) -> None:
        super().__init__(in_channels, out_channels, kernel, stride=stride, bias=bias)
        self.same = padding == "SAME"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = (0, 0)
        if self.same:
            (kh, kw), (sh, sw) = self.kernel_size, self.stride
            top, bottom = _same_pads(x.shape[2], kh, sh)
            left, right = _same_pads(x.shape[3], kw, sw)
            if (top, left) == (bottom, right):
                pad = (top, left)  # symmetric: the convolution pads
            else:
                x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, self.stride, pad)


def _group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(_gn_groups(channels), channels, eps=_GN_EPS)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


class LeNet5(FlaxInit):
    """Classic LeNet-5 for 28x28 inputs."""

    def __init__(self, num_classes: int = 10, channels: int = 1, image_size: int = 28) -> None:
        super().__init__()
        self.Conv_0 = Conv(channels, 6, 5)
        self.Conv_1 = Conv(6, 16, 5, padding="VALID")
        side = (image_size // 2 - 4) // 2
        self.Dense_0 = nn.Linear(16 * side * side, 120)
        self.Dense_1 = nn.Linear(120, 84)
        self.Dense_2 = nn.Linear(84, num_classes)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = F.avg_pool2d(F.relu(self.Conv_0(_nchw(x))), 2)
        x = F.avg_pool2d(F.relu(self.Conv_1(x)), 2)
        # the JAX Dense reads an NHWC flatten: permute the activation back
        x = x.permute(0, 2, 3, 1).flatten(1)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


class DenseLayer(nn.Module):
    def __init__(self, in_channels: int, growth_rate: int) -> None:
        super().__init__()
        self.GroupNorm_0 = _group_norm(in_channels)
        self.Conv_0 = Conv(in_channels, growth_rate, 3, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Conv_0(F.relu(self.GroupNorm_0(x)))
        return torch.cat([x, y], dim=1)


class TransitionLayer(nn.Module):
    def __init__(self, in_channels: int, out_features: int) -> None:
        super().__init__()
        self.GroupNorm_0 = _group_norm(in_channels)
        self.Conv_0 = Conv(in_channels, out_features, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.Conv_0(F.relu(self.GroupNorm_0(x))), 2)


class DenseNet40(FlaxInit):
    """DenseNet-40 (k=12, 3 dense blocks of 12 layers)."""

    def __init__(self, num_classes: int = 10, growth_rate: int = 12, channels: int = 3) -> None:
        super().__init__()
        self.growth_rate = growth_rate
        self.Conv_0 = Conv(channels, 16, 3, bias=False)
        width, layer, self._order = 16, 0, []
        for block in range(3):
            for _ in range(12):
                name = f"DenseLayer_{layer}"
                self.add_module(name, DenseLayer(width, growth_rate))
                self._order.append(name)
                width, layer = width + growth_rate, layer + 1
            if block < 2:
                name = f"TransitionLayer_{block}"
                self.add_module(name, TransitionLayer(width, width // 2))
                self._order.append(name)
                width //= 2
        self.GroupNorm_0 = _group_norm(width)
        self.Dense_0 = nn.Linear(width, num_classes)
        #: the regions remat checkpoints one by one (``engine/engine.py``)
        self.remat_blocks = tuple(self._order)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = self.Conv_0(_nchw(x))
        for name in self._order:
            x = getattr(self, name)(x)
        x = F.relu(self.GroupNorm_0(x)).mean(dim=(2, 3))
        return self.Dense_0(x)


class ResNetBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, features: int, stride: int = 1) -> None:
        super().__init__()
        self.Conv_0 = Conv(in_channels, features, 3, stride, bias=False)
        self.GroupNorm_0 = _group_norm(features)
        self.Conv_1 = Conv(features, features, 3, bias=False)
        self.GroupNorm_1 = _group_norm(features)
        # the JAX block adds the projection where the shapes differ: in
        # these ResNets exactly where the width or the stride changes
        if in_channels != features or stride != 1:
            self.shortcut = Conv(in_channels, features, 1, stride, bias=False)
            self.GroupNorm_2 = _group_norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        if hasattr(self, "shortcut"):
            x = self.GroupNorm_2(self.shortcut(x))
        return F.relu(y + x)


class BottleneckBlock(nn.Module):
    """1x1 reduce -> 3x3 -> 1x1 expand (x4)."""

    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1) -> None:
        super().__init__()
        out_features = features * 4
        self.Conv_0 = Conv(in_channels, features, 1, bias=False)
        self.GroupNorm_0 = _group_norm(features)
        self.Conv_1 = Conv(features, features, 3, stride, bias=False)
        self.GroupNorm_1 = _group_norm(features)
        self.Conv_2 = Conv(features, out_features, 1, bias=False)
        self.GroupNorm_2 = _group_norm(out_features)
        if in_channels != out_features or stride != 1:
            self.shortcut = Conv(in_channels, out_features, 1, stride, bias=False)
            self.GroupNorm_3 = _group_norm(out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = F.relu(self.GroupNorm_1(self.Conv_1(y)))
        y = self.GroupNorm_2(self.Conv_2(y))
        if hasattr(self, "shortcut"):
            x = self.GroupNorm_3(self.shortcut(x))
        return F.relu(y + x)


class ResNet(FlaxInit):
    def __init__(
        self,
        num_classes: int = 10,
        stage_sizes: tuple[int, ...] = (2, 2, 2, 2),
        width: int = 64,
        bottleneck: bool = False,
        channels: int = 3,
    ) -> None:
        super().__init__()
        self.stage_sizes, self.width, self.bottleneck = tuple(stage_sizes), width, bottleneck
        self.Conv_0 = Conv(channels, width, 3, bias=False)
        self.GroupNorm_0 = _group_norm(width)
        block_cls = BottleneckBlock if bottleneck else ResNetBlock
        in_channels, self._blocks = width, []
        for stage, n_blocks in enumerate(self.stage_sizes):
            features = width * 2**stage
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                name = f"{block_cls.__name__}_{len(self._blocks)}"
                self.add_module(name, block_cls(in_channels, features, stride))
                self._blocks.append(name)
                in_channels = features * block_cls.expansion
        self.Dense_0 = nn.Linear(in_channels, num_classes)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = F.relu(self.GroupNorm_0(self.Conv_0(_nchw(x))))
        for name in self._blocks:
            x = getattr(self, name)(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


def _context(name: str, module: nn.Module, dataset_collection, device) -> ModelContext:
    return ModelContext(
        name=name,
        module=module.to(device),
        num_classes=dataset_collection.num_classes,
        device=device,
    )


@register_model("LeNet5", "lenet5")
def _lenet5(dataset_collection, device, **kwargs) -> ModelContext:
    _, size, _, channels = example_batch(dataset_collection).shape
    module = LeNet5(dataset_collection.num_classes, channels=channels, image_size=size)
    return _context("LeNet5", module, dataset_collection, device)


@register_model("densenet40")
def _densenet40(dataset_collection, device, **kwargs) -> ModelContext:
    channels = example_batch(dataset_collection).shape[3]
    module = DenseNet40(dataset_collection.num_classes, channels=channels)
    return _context("densenet40", module, dataset_collection, device)


@register_model("resnet18", "ResNet18")
def _resnet18(dataset_collection, device, **kwargs) -> ModelContext:
    channels = example_batch(dataset_collection).shape[3]
    module = ResNet(dataset_collection.num_classes, stage_sizes=(2, 2, 2, 2), channels=channels)
    return _context("resnet18", module, dataset_collection, device)


@register_model("resnet50", "ResNet50")
def _resnet50(dataset_collection, device, **kwargs) -> ModelContext:
    channels = example_batch(dataset_collection).shape[3]
    module = ResNet(
        dataset_collection.num_classes, stage_sizes=(3, 4, 6, 3), bottleneck=True, channels=channels
    )
    return _context("resnet50", module, dataset_collection, device)
