"""Material property registry in array form.

The reference keeps materials as a plain dict of per-material absorption and
frequency coefficients (reference: materials.py:3-17) that is consulted inside
Python loops (reference: utils.py:50-65).  For a batched XLA graph we need the
table as dense arrays indexed by integer material id, so attenuation becomes a
gather + elementwise math over whole (paths, mics) tensors instead of a scalar
Python call per path.

Public surface:
  - ``material_properties``: dict with the same keys/values as the reference,
    kept for API compatibility (users extend it per README.md:180-202).
  - ``MaterialTable``: frozen arrays (absorption, freq) + name->id mapping,
    built from any ``material_properties``-shaped dict.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np

# Same default table as the reference (materials.py:3-17).  Users may mutate /
# extend this dict exactly as with the reference.
material_properties: Dict[str, Dict[str, float]] = {
    "air": {"absorption": 0.01, "freq": 0.1},
    "wood": {"absorption": 0.05, "freq": 0.8},
    "metal": {"absorption": 0.1, "freq": 0.6},
}

DEFAULT_MATERIAL = "air"


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """Dense, device-friendly material table.

    ``absorption`` and ``freq`` are float arrays of shape (num_materials,);
    ``ids`` maps material name -> row index.  Row 0 is always the fallback
    material ('air' semantics, reference utils.py:57-59).
    """

    names: tuple
    ids: Mapping[str, int]
    absorption: np.ndarray
    freq: np.ndarray

    @staticmethod
    def from_dict(props: Mapping[str, Mapping[str, float]] | None = None,
                  fallback: str = DEFAULT_MATERIAL) -> "MaterialTable":
        props = dict(props if props is not None else material_properties)
        if fallback not in props:
            raise ValueError(f"fallback material {fallback!r} missing from table")
        # Fallback first so unknown-material lookups resolve to row 0.
        names = [fallback] + [n for n in props if n != fallback]
        for n in names:
            entry = props[n]
            if "absorption" not in entry or "freq" not in entry:
                # Same contract as reference utils.py:95-96.
                raise ValueError(
                    f"Absorption or frequency property missing for material {n!r}.")
        absorption = np.array([props[n]["absorption"] for n in names], np.float64)
        freq = np.array([props[n]["freq"] for n in names], np.float64)
        ids = {n: i for i, n in enumerate(names)}
        return MaterialTable(tuple(names), ids, absorption, freq)

    def id_of(self, name: str, *, strict: bool = False) -> int:
        """Material id; unknown names fall back to row 0 ('air') like the
        reference's warning path (utils.py:57-59) unless strict."""
        if name in self.ids:
            return self.ids[name]
        if strict:
            # Reference raises for unknown materials during image-source
            # generation (utils.py:93-94).
            raise ValueError(f"Material {name!r} is not defined.")
        return 0


def default_table() -> MaterialTable:
    """Table built from the current (possibly user-extended) registry."""
    return MaterialTable.from_dict(material_properties)
