from .convert import state_dict_from_jax, train_state_from_jax
from .meters import AverageMeter

__all__ = ["AverageMeter", "state_dict_from_jax", "train_state_from_jax"]
