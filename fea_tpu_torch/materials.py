"""Material presets (the port's own copy of fea_tpu/materials.py).

Mirrors the reference's material table (datagen/mesh_generator.py:19-55):
18 (name, Young's modulus E [MPa], Poisson ratio nu) presets sampled
uniformly when assigning materials to clustered mesh regions.
"""

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Material:
    name: str
    youngs_modulus: float
    poissons_ratio: float

    def as_tuple(self) -> Tuple[float, float]:
        return (float(self.youngs_modulus), float(self.poissons_ratio))


MATERIALS = [
    Material("Steel", 210000, 0.3),
    Material("Aluminum", 68900, 0.33),
    Material("Copper", 117000, 0.34),
    Material("Brass", 97000, 0.33),
    Material("Titanium", 105000, 0.34),
    Material("Stainless Steel", 195000, 0.3),
    Material("Nickel", 207000, 0.31),
    Material("Zinc", 100000, 0.25),
    Material("Lead", 17500, 0.44),
    Material("Magnesium", 46500, 0.35),
    Material("Concrete", 30000, 0.2),
    Material("Fibre Glass", 84700, 0.26),
    Material("Carbon Fibre A4S", 225000, 0.25),
    Material("Bronze", 120000, 0.34),
    Material("Tungsten", 411000, 0.28),
    Material("Silver", 83000, 0.37),
    Material("Gold", 78000, 0.44),
    Material("Platinum", 168000, 0.38),
]
