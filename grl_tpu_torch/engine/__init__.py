from . import metrics, visualize
from .evaluator import EvalResult, Evaluator, cosine_distance, eval_items, make_descriptor_fn, print_protocol
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
    "eval_items",
    "grl_loss_fn",
    "init_train_state",
    "lr_mult_tree",
    "make_descriptor_fn",
    "make_train_step",
    "metrics",
    "print_protocol",
    "re_ranking",
    "step_decay_lr",
    "visualize",
    "warn_if_degenerate",
]
