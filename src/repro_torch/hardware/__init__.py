"""Hardware plant abstraction: one device interface for every MGD mode.

    IdealPlant      in-process, writes land exactly
    NoisyPlant      σ_C readout noise + σ_θ write noise (paper §3.5)
    QuantizedPlant  limited-bit DAC weight writes, slow-write lag, cost ADC
    DriftingPlant   weights random-walk / decay between writes (aging)

    ExternalPlant   host boundary around one lab instrument (§4/§6)
    ChipFarm        k external chips probed concurrently (§6 chip farm)

``devices.py`` builds defective MLPs behind them, and the numpy chips
(``SimulatedAnalogChip``, ``DriftingAnalogChip``, ``LinearLaneChip``)
that sit behind the host boundary.  ``faults.py`` is that boundary's
robustness layer: ``FaultyChip`` injects counter-keyed faults,
``FaultPolicy`` arms ``ExternalPlant``/``ChipFarm`` with timeouts,
retries, masking, quarantine and robust aggregation.  ``backend/``
picks who runs a farm's device transactions: ``serial``, ``thread``,
``process`` (forked workers built from ``DeviceSpec``s) or ``cluster``
(the wire-protocol stub).
"""
from .backend import (BACKENDS, ClusterStubBackend, DeviceSpec,
                      FarmBackend, ProcessBackend, SerialBackend,
                      ThreadBackend, loopback_transport, make_backend)
from .base import IdealPlant, Plant, PlantMeta
from .devices import (DriftingAnalogChip, LinearLaneChip,
                      SimulatedAnalogChip, mlp_device_fns, noisy_mlp_plant,
                      quantized_mlp_plant)
from .external import ExternalPlant
from .farm import ChipFarm, simulated_chip_farm
from .faults import (DEFAULT_TIMEOUT_S, ChipFaultError, ChipHealth,
                     FarmHealth, FaultEvent, FaultLog, FaultPolicy,
                     FaultSpec, FaultyChip, InjectedFault)
from .plants import (DriftingPlant, NoisyPlant, QuantizedPlant,
                     plant_from_config)

__all__ = [
    "Plant", "PlantMeta", "IdealPlant", "NoisyPlant", "QuantizedPlant",
    "DriftingPlant", "ExternalPlant", "ChipFarm", "plant_from_config",
    "SimulatedAnalogChip", "DriftingAnalogChip", "LinearLaneChip",
    "mlp_device_fns",
    "noisy_mlp_plant", "quantized_mlp_plant", "simulated_chip_farm",
    "ChipFaultError", "ChipHealth", "DEFAULT_TIMEOUT_S", "FarmHealth",
    "FaultEvent", "FaultLog", "FaultPolicy", "FaultSpec", "FaultyChip",
    "InjectedFault",
    "BACKENDS", "ClusterStubBackend", "DeviceSpec", "FarmBackend",
    "ProcessBackend", "SerialBackend", "ThreadBackend",
    "loopback_transport", "make_backend",
]
