"""Model factory (counterpart of ``grl_tpu/models/__init__.py``)."""

import torch

from .. import resolve_device
from .gce import GCEBackbone
from .grl import GRLModel
from .init import init_weights
from .resnet import Bottleneck, ResNetTrunk, resnet50_trunk
from .resnet_baseline import ResNetBaseline
from .siamese import Siamese, SiameseVideo, pairwise_verification
from .trl import MemoryBlock, TRLBlock
from .two_stream import TwoStreamBaseline, two_stream_tiny

_factory = {
    "resnet50_grl": GRLModel,
    "resnet50": ResNetBaseline,
    "siamese": Siamese,
    "siamese_video": SiameseVideo,
    "two_stream": TwoStreamBaseline,
}


def names():
    return sorted(_factory.keys())


def create(name, device=None, seed=0, **kwargs):
    """Build a registered model on ``device`` (default ``"cuda"``) with fresh
    weights drawn from a ``torch.Generator`` seeded with ``seed``; the
    keyword arguments, ``compute_dtype`` among them, go to the model."""
    if name not in _factory:
        raise KeyError(f"Unknown model: {name}; available: {names()}")
    device = resolve_device(device)
    model = _factory[name](**kwargs)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device)


__all__ = [
    "create",
    "names",
    "init_weights",
    "GRLModel",
    "GCEBackbone",
    "TRLBlock",
    "MemoryBlock",
    "Siamese",
    "SiameseVideo",
    "pairwise_verification",
    "ResNetTrunk",
    "ResNetBaseline",
    "TwoStreamBaseline",
    "two_stream_tiny",
    "Bottleneck",
    "resnet50_trunk",
]
