from .convert import load_imagenet_resnet50, state_dict_from_jax, train_state_from_jax
from .logging import Logger, ScalarWriter
from .meters import AverageMeter
from .serialization import (
    AsyncCheckpointer,
    load_train_state,
    mkdir_if_missing,
    read_json,
    save_train_state,
    write_json,
)

__all__ = [
    "AsyncCheckpointer",
    "AverageMeter",
    "Logger",
    "ScalarWriter",
    "load_imagenet_resnet50",
    "load_train_state",
    "mkdir_if_missing",
    "read_json",
    "save_train_state",
    "state_dict_from_jax",
    "train_state_from_jax",
    "write_json",
]
