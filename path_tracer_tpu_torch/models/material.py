"""Materials.

Parity: ``Material`` / ``ReflectType`` in the reference
(``src/render/mod.rs:71-83``). The serialized field name ``emmission`` (sic)
is kept for JSON compatibility with the reference's scene files.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np


class ReflectType(enum.IntEnum):
    """BRDF selector. Integer values are the packed device encoding."""

    DIFFUSE = 0
    SPECULAR = 1
    REFRACT = 2

    @staticmethod
    def from_json(name: str) -> "ReflectType":
        try:
            return _JSON_NAMES[name]
        except KeyError:
            raise ValueError(f"unknown reflect_type: {name!r}") from None

    def to_json(self) -> str:
        return _JSON_NAMES_INV[self]


_JSON_NAMES = {
    "Diffuse": ReflectType.DIFFUSE,
    "Specular": ReflectType.SPECULAR,
    "Refract": ReflectType.REFRACT,
}
_JSON_NAMES_INV = {v: k for k, v in _JSON_NAMES.items()}


def _vec3(x) -> np.ndarray:
    v = np.asarray(x, dtype=np.float32)
    if v.shape != (3,):
        raise ValueError(f"expected 3-vector, got shape {v.shape}")
    return v


@dataclass
class Material:
    color: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    emission: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    reflect_type: ReflectType = ReflectType.DIFFUSE

    def __post_init__(self):
        self.color = _vec3(self.color)
        self.emission = _vec3(self.emission)
        self.reflect_type = ReflectType(self.reflect_type)

    @staticmethod
    def from_json(obj: dict) -> "Material":
        return Material(
            color=_vec3(obj["color"]),
            emission=_vec3(obj["emmission"]),  # sic — reference spelling
            reflect_type=ReflectType.from_json(obj["reflect_type"]),
        )

    def to_json(self) -> dict:
        return {
            "color": self.color,
            "emmission": self.emission,  # sic — reference spelling
            "reflect_type": self.reflect_type.to_json(),
        }

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Material)
            and np.array_equal(self.color, other.color)
            and np.array_equal(self.emission, other.emission)
            and self.reflect_type == other.reflect_type
        )
