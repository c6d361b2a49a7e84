"""Application problem specs: cantilever, gusset, shearblade, composite
(the port's own copy of fea_tpu/apps/specs.py, as data).

Re-encodes the reference's declarative sfepy configs
(applications/cantilever/cantilever.py:43-72, gusset/gusset.py:38-85,
shearblade/shearblade.py:43-72) and the composite datagen notebook
(applications/composite/datagenapplication.ipynb) as data. Selectors are
coordinate-based (not node indices) so specs work both on the checked-in
fixture meshes and on meshes regenerated by the native CDT mesher.

Load semantics: dw_point_load applies the value at every vertex of the
region. The sfepy-run apps use their values as-is; the composite app goes
through the datagen path whose ramp is force(t) = -t * magnitude
(fea_analysis.py:314-322), hence negate_loads=True.
"""

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np


@dataclass
class LoadSpec:
    value: Tuple[float, float]
    # exactly one selector:
    vertex: Optional[Tuple[float, float]] = None  # corner coordinate
    predicate: Optional[Callable] = None  # facet-region predicate on coords
    collinear: Optional[Tuple[Tuple[float, float], Tuple[float, float]]] = None


@dataclass
class MaterialSplit:
    """Region = nodes satisfying the predicate (strict cell semantics)."""

    young: float
    poisson: float
    predicate: Callable  # coords -> bool mask


@dataclass
class ApplicationSpec:
    name: str
    polygon: np.ndarray  # CCW exterior ring for standalone meshing
    mesh_size: float = 1e-2
    mesh_fixture: Optional[str] = None  # reference MEDIT mesh for parity
    young: float = 210000.0
    poisson: float = 0.3
    material_regions: Optional[List[MaterialSplit]] = None
    constraint_predicates: List[Callable] = field(default_factory=list)
    constraint_vertices: List[Tuple[float, float]] = field(default_factory=list)
    loads: List[LoadSpec] = field(default_factory=list)
    negate_loads: bool = False
    num_steps: int = 2


_REF = "/root/reference/applications"

CANTILEVER = ApplicationSpec(
    name="cantilever",
    polygon=np.array([[0.0, 0.4], [1.0, 0.4], [1.0, 0.6], [0.0, 0.6]]),
    mesh_fixture=f"{_REF}/cantilever/cantilever.mesh",
    constraint_predicates=[lambda c: c[:, 0] < 0.01],
    loads=[LoadSpec(value=(0.0, -1000.0), vertex=(1.0, 0.6))],
)

GUSSET = ApplicationSpec(
    name="gusset",
    polygon=np.array(
        [[0.0, 0.0], [1.0, 0.0], [1.0, 0.5], [0.5, 1.0], [0.0, 1.0]]
    ),
    mesh_fixture=f"{_REF}/gusset/gusset.mesh",
    constraint_predicates=[
        lambda c: c[:, 1] < 0.01,
        lambda c: c[:, 0] < 0.01,
    ],
    loads=[
        LoadSpec(value=(1000.0, 0.0), predicate=lambda c: c[:, 0] > 0.99),
        LoadSpec(value=(1000.0, 1000.0), collinear=((0.5, 1.0), (1.0, 0.5))),
    ],
)

SHEARBLADE = ApplicationSpec(
    name="shearblade",
    polygon=np.array(
        [[0.0, 0.25], [1.0, 0.35], [1.0, 0.75], [0.0, 0.75]]
    ),
    mesh_fixture=f"{_REF}/shearblade/shearblade.mesh",
    constraint_predicates=[lambda c: c[:, 1] > 0.74],
    loads=[LoadSpec(value=(100.0, 3000.0), vertex=(0.0, 0.25))],
    # The reference's shearblade.py declares Load (100, 3000) but its
    # checked-in shearblade.vtk is the exact NEGATIVE of that solve — the
    # fixture was evidently produced through the datagen path whose ramp is
    # force = -magnitude. We match the artifact.
    negate_loads=True,
)

COMPOSITE = ApplicationSpec(
    name="composite",
    polygon=np.array(
        [
            [0.0, 0.0875],
            [0.025, 0.0875],
            [0.975, 0.0875],
            [1.0, 0.0875],
            [1.0, 0.9125],
            [0.85, 0.9125],
            [0.6, 0.9125],
            [0.4, 0.9125],
            [0.15, 0.9125],
            [0.0, 0.9125],
        ][::-1]  # notebook ring is CW; store CCW
    ),
    mesh_fixture=f"{_REF}/composite/test.mesh",
    material_regions=[
        MaterialSplit(30000.0, 0.2, lambda c: c[:, 1] > 0.6875),  # concrete
        MaterialSplit(210000.0, 0.3, lambda c: c[:, 1] <= 0.6875),  # steel
    ],
    constraint_vertices=[(0.025, 0.0875), (0.975, 0.0875)],
    loads=[
        LoadSpec(value=(0.0, -200.0), vertex=(0.85, 0.9125)),
        LoadSpec(value=(0.0, -200.0), vertex=(0.6, 0.9125)),
        LoadSpec(value=(0.0, -200.0), vertex=(0.4, 0.9125)),
        LoadSpec(value=(0.0, -200.0), vertex=(0.15, 0.9125)),
    ],
    negate_loads=True,
)

from dataclasses import replace as _replace

# The composite notebook splits nodes with strict predicates (y > 0.6875 vs
# y <= 0.6875), which under sfepy's cell-region semantics mechanically
# DECOUPLES the two materials — its own fixture shows the resulting garbage
# solve (ranges ~1e10). This variant overlaps the regions by one element
# band across the interface so straddling cells are fully contained in one
# region, coupling the materials — the physically intended two-material
# plate. (Region order matters: first match wins for the overlap band.)
_INTERFACE_BAND = 0.011  # slightly over the 1e-2 mesh size


COMPOSITE_COUPLED = _replace(
    COMPOSITE,
    name="composite_coupled",
    material_regions=[
        MaterialSplit(
            30000.0, 0.2, lambda c: c[:, 1] > 0.6875 - _INTERFACE_BAND
        ),
        MaterialSplit(210000.0, 0.3, lambda c: c[:, 1] <= 0.6875),
    ],
)

APPLICATIONS = {
    "cantilever": CANTILEVER,
    "gusset": GUSSET,
    "shearblade": SHEARBLADE,
    "composite": COMPOSITE,
    "composite_coupled": COMPOSITE_COUPLED,
}
