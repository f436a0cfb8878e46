from . import metrics
from .evaluator import EvalResult, Evaluator, cosine_distance, make_descriptor_fn
from .rerank import re_ranking, warn_if_degenerate

__all__ = [
    "EvalResult",
    "Evaluator",
    "cosine_distance",
    "make_descriptor_fn",
    "metrics",
    "re_ranking",
    "warn_if_degenerate",
]
