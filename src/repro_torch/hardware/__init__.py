"""Hardware plant abstraction (ideal device only, so far)."""
from .base import IdealPlant, Plant, PlantMeta
from .plants import plant_from_config

__all__ = ["Plant", "PlantMeta", "IdealPlant", "plant_from_config"]
