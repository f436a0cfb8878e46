from .catalogs import SyntheticVideoReID
from .loader import ClipDataset, ClipLoader
from .transforms import normalize

__all__ = ["ClipDataset", "ClipLoader", "SyntheticVideoReID", "normalize"]
