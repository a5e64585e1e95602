"""Component class taxonomy and SPICE-prefix registry.

Re-implements the class bookkeeping of the reference analyzer:
  - full 62-entry detector label space  (classes.json:1-81)
  - runtime filtering into a usable set (src/circuit_analyzer.py:57-63)
  - SPICE netlist prefix map            (src/circuit_analyzer.py:66-102)
  - semantic class groupings            (src/circuit_analyzer.py:51-52,110-131)
"""
from __future__ import annotations

from types import MappingProxyType

# Full detector label space (classes.json). Index == detector class id.
CLASSES: MappingProxyType = MappingProxyType(
    {
        "__background__": 0,
        "text": 1,
        "junction": 2,
        "crossover": 3,
        "terminal": 4,
        "gnd": 5,
        "vss": 6,
        "voltage.dc": 7,
        "voltage.ac": 8,
        "voltage.battery": 9,
        "resistor": 10,
        "resistor.adjustable": 11,
        "resistor.photo": 12,
        "capacitor.unpolarized": 13,
        "capacitor.polarized": 14,
        "capacitor.adjustable": 15,
        "inductor": 16,
        "inductor.ferrite": 17,
        "inductor.coupled": 18,
        "transformer": 19,
        "diode": 20,
        "diode.light_emitting": 21,
        "diode.thyrector": 22,
        "diode.zener": 23,
        "diac": 24,
        "triac": 25,
        "thyristor": 26,
        "varistor": 27,
        "transistor.bjt": 28,
        "transistor.fet": 29,
        "transistor.photo": 30,
        "operational_amplifier": 31,
        "operational_amplifier.schmitt_trigger": 32,
        "optocoupler": 33,
        "integrated_circuit": 34,
        "integrated_circuit.ne555": 35,
        "integrated_circuit.voltage_regulator": 36,
        "xor": 37,
        "and": 38,
        "or": 39,
        "not": 40,
        "nand": 41,
        "nor": 42,
        "probe": 43,
        "probe.current": 44,
        "probe.voltage": 45,
        "switch": 46,
        "relay": 47,
        "socket": 48,
        "fuse": 49,
        "speaker": 50,
        "motor": 51,
        "lamp": 52,
        "microphone": 53,
        "antenna": 54,
        "crystal": 55,
        "mechanical": 56,
        "magnetic": 57,
        "optical": 58,
        "block": 59,
        "explanatory": 60,
        "unknown": 61,
    }
)

#: Trainable detector extension (NOT in the reference's classes.json):
#: the reference label space has no bare "capacitor" (only the
#: .unpolarized/.polarized/.adjustable subtypes) and no current-source
#: class at all — its fine-tune set had none — but the synthetic circuit
#: grammar (eval/randomized.py) and the MNA simulator use both. They are
#: appended AFTER the reference's 62 ids so every reference id is
#: untouched: a 62-class checkpoint can never emit them, a 64-class
#: trainable checkpoint (scripts/train_detector.py) can. Training with
#: the un-extended map silently sent every capacitor/current-source GT
#: box to id 0 (__background__) — measured AP@50 of exactly 0.000 for
#: both despite 36/51 val instances.
TRAIN_EXTRA_CLASSES: MappingProxyType = MappingProxyType(
    {"capacitor": 62, "current.dc": 63}
)

#: Reference map + trainable extension — the label space the in-repo
#: trainers target (dict order preserves id order).
TRAIN_CLASSES: MappingProxyType = MappingProxyType(
    {**CLASSES, **TRAIN_EXTRA_CLASSES}
)

ID_TO_NAME: MappingProxyType = MappingProxyType(
    {v: k for k, v in TRAIN_CLASSES.items()}
)

# Runtime filtering sets (src/circuit_analyzer.py:57-59)
REDUCING = frozenset(
    {
        "operational_amplifier.schmitt_trigger",
        "integrated_circuit.ne555",
        "resistor.photo",
        "diode.thyrector",
    }
)
DELETING = frozenset(
    {"optical", "__background__", "inductor.coupled", "mechanical", "block", "magnetic"}
)
UNKNOWN = frozenset(
    {
        "relay",
        "antenna",
        "diac",
        "triac",
        "crystal",
        "probe",
        "probe.current",
        "probe.voltage",
        "optocoupler",
        "socket",
        "fuse",
        "speaker",
        "motor",
        "lamp",
        "microphone",
        "transistor.photo",
        "xor",
        "and",
        "or",
        "not",
        "nand",
        "nor",
    }
)

#: Usable class names after filtering (src/circuit_analyzer.py:61)
USABLE_CLASSES = frozenset(CLASSES) - DELETING - UNKNOWN - REDUCING

#: Structural, non-electrical classes (src/circuit_analyzer.py:51)
NON_COMPONENTS = frozenset({"text", "junction", "crossover", "vss", "explanatory", "circuit"})

#: Source classes (src/circuit_analyzer.py:52)
SOURCE_COMPONENTS = frozenset(
    {"voltage.ac", "voltage.dc", "voltage.dependent", "current.dc", "current.dependent"}
)

#: Classes preserved in the wire mask during component subtraction
#: (src/circuit_analyzer.py:862, :1332)
MASK_PRESERVE_CLASSES = frozenset({"crossover", "junction", "circuit", "vss"})

#: Classes excluded from clustering when deciding the crop window
#: (src/circuit_analyzer.py:982-985; junctions ARE included)
CROP_CLUSTER_EXCLUDE = frozenset({"text", "explanatory", "circuit", "vss", "crossover"})

#: Classes skipped during netlist emission (src/circuit_analyzer.py:1654)
NETLIST_IGNORE_CLASSES = frozenset({"text", "explanatory", "junction", "crossover"})

#: Classes routed to the direction VLM (src/circuit_analyzer.py:113-118)
DIRECTION_CLASSES = frozenset(
    {
        "voltage.dc",
        "voltage.ac",
        "diode",
        "diode.light_emitting",
        "diode.zener",
        "transistor.bjt",
        "unknown",
    }
)

#: Voltage-source-like classes for node-ordering (src/circuit_analyzer.py:128)
VOLTAGE_CLASSES = frozenset({"voltage.dc", "voltage.ac", "transistor.bjt", "unknown"})
#: Diode classes (src/circuit_analyzer.py:129)
DIODE_CLASSES = frozenset({"diode", "diode.light_emitting", "diode.zener"})
#: Current-source classes (src/circuit_analyzer.py:130)
CURRENT_SOURCE_CLASSES = frozenset({"current.dc", "current.dependent"})

#: Project-of-interest classes (src/circuit_analyzer.py:65)
PROJECT_CLASSES = frozenset(
    {
        "gnd",
        "voltage.ac",
        "voltage.dc",
        "resistor",
        "voltage.dependent",
        "current.dc",
        "current.dependent",
        "capacitor",
        "inductor",
        "diode",
    }
)

#: SPICE prefix map (src/circuit_analyzer.py:66-102)
NETLIST_MAP: MappingProxyType = MappingProxyType(
    {
        "resistor": "R",
        "resistor.adjustable": "R",
        "capacitor": "C",
        "capacitor.unpolarized": "C",
        "capacitor.polarized": "C",
        "capacitor.adjustable": "C",
        "inductor": "L",
        "inductor.ferrite": "L",
        "diode": "D",
        "diode.light_emitting": "D",
        "diode.zener": "D",
        "transistor.bjt": "Q",
        "transistor.fet": "M",
        "voltage.ac": "V",
        "voltage.dc": "V",
        "voltage.battery": "V",
        "voltage.dependent": "E",
        "current.dc": "I",
        "current.ac": "I",
        "current.dependent": "G",
        "vss": "GND",
        "gnd": "0",
        "switch": "S",
        "integrated_circuit": "X",
        "integrated_circuit.voltage_regulator": "X",
        "operational_amplifier": "X",
        "thyristor": "Q",
        "transformer": "T",
        "varistor": "RV",
        "terminal": "N",
        "junction": "",
        "crossover": "",
        "explanatory": "",
        "text": "",
        "unknown": "UN",
    }
)


def spice_prefix(class_name: str) -> str:
    """SPICE element prefix for a class; 'UN' for unmapped classes."""
    return NETLIST_MAP.get(class_name, "UN")


def pixel_threshold_for_class(class_name: str, cfg=None) -> int:
    """Terminal-matching pixel threshold (src/circuit_analyzer.py:1407-1415)."""
    default, source, diode = (6, 20, 8)
    if cfg is not None:
        default = cfg.pixel_threshold_default
        source = cfg.pixel_threshold_source
        diode = cfg.pixel_threshold_diode
    if class_name in SOURCE_COMPONENTS:
        return source
    if class_name in {"diode", "diode.light_emitting", "diode.zener", "transistor.bjt", "transistor.fet"}:
        return diode
    return default
