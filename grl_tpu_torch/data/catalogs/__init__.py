from .synthetic import InfoStruct, SyntheticVideoReID

__all__ = ["InfoStruct", "SyntheticVideoReID"]
