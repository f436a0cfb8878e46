"""Dataset catalog factory (counterpart of ``grl_tpu/data/catalogs/__init__.py``)."""

from .duke import DukeMTMCVidReID
from .mars import Mars
from .prepare import prepare_ilidsvid, prepare_prid2011
from .sequence import PRID2011Sequence, SequenceDataset, iLIDSVIDSequence
from .synthetic import InfoStruct, SyntheticVideoReID

_factory = {
    "mars": Mars,
    "duke": DukeMTMCVidReID,
    "ilidsvidsequence": iLIDSVIDSequence,
    "prid2011sequence": PRID2011Sequence,
    "synthetic": SyntheticVideoReID,
}


def names():
    return sorted(_factory.keys())


def get_sequence(name, *args, **kwargs):
    if name not in _factory:
        raise KeyError(f"Unknown dataset: {name}; available: {names()}")
    return _factory[name](*args, **kwargs)


__all__ = [
    "get_sequence",
    "names",
    "prepare_ilidsvid",
    "prepare_prid2011",
    "DukeMTMCVidReID",
    "InfoStruct",
    "Mars",
    "PRID2011Sequence",
    "SequenceDataset",
    "SyntheticVideoReID",
    "iLIDSVIDSequence",
]
