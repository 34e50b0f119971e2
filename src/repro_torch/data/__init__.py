from .pipeline import SyntheticLMData, UnitBatcher

__all__ = ["SyntheticLMData", "UnitBatcher"]
