"""Training losses (counterpart of ``grl_tpu/losses/__init__.py``)."""

from .oim import OIMLoss, cross_entropy, init_lut, max_repeats, oim_logits, update_lut
from .pairloss import PairLoss, pair_loss, pair_loss_from_logits
from .triplet import TripletLoss, TripletLossOIM, euclidean_cdist

__all__ = [
    "OIMLoss",
    "init_lut",
    "oim_logits",
    "update_lut",
    "max_repeats",
    "cross_entropy",
    "PairLoss",
    "pair_loss",
    "pair_loss_from_logits",
    "TripletLoss",
    "TripletLossOIM",
    "euclidean_cdist",
]
