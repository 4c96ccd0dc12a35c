"""Hardware plant abstraction: one device interface for every MGD mode.

    IdealPlant      in-process, writes land exactly
    NoisyPlant      σ_C readout noise + σ_θ write noise (paper §3.5)
    QuantizedPlant  limited-bit DAC weight writes, slow-write lag, cost ADC
    DriftingPlant   weights random-walk / decay between writes (aging)

``devices.py`` builds defective MLPs behind them.  External plants,
chip farms and the fault policy are not ported yet (ROADMAP A12).
"""
from .base import IdealPlant, Plant, PlantMeta
from .devices import mlp_device_fns, noisy_mlp_plant, quantized_mlp_plant
from .plants import (DriftingPlant, NoisyPlant, QuantizedPlant,
                     plant_from_config)

__all__ = ["Plant", "PlantMeta", "IdealPlant", "NoisyPlant",
           "QuantizedPlant", "DriftingPlant", "plant_from_config",
           "mlp_device_fns", "noisy_mlp_plant", "quantized_mlp_plant"]
