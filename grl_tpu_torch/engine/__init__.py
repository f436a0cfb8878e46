from . import metrics
from .evaluator import EvalResult, Evaluator, cosine_distance, make_descriptor_fn
from .optim import SGD, lr_mult_tree, step_decay_lr
from .rerank import re_ranking, warn_if_degenerate
from .train_step import TrainState, grl_loss_fn, init_train_state, make_train_step
from .trainer import Trainer

__all__ = [
    "EvalResult",
    "Evaluator",
    "SGD",
    "TrainState",
    "Trainer",
    "cosine_distance",
    "grl_loss_fn",
    "init_train_state",
    "lr_mult_tree",
    "make_descriptor_fn",
    "make_train_step",
    "metrics",
    "re_ranking",
    "step_decay_lr",
    "warn_if_degenerate",
]
