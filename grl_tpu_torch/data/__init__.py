from .catalogs import SyntheticVideoReID
from .loader import ClipDataset, ClipLoader, get_data
from .sampling import RandomPairSampler
from .transforms import augment, normalize

__all__ = ["ClipDataset", "ClipLoader", "RandomPairSampler", "SyntheticVideoReID", "augment",
           "get_data", "normalize"]
