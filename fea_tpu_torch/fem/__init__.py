from .direct import direct_solve
from .elasticity import element_stiffness, plane_strain_stiffness
from .problem import SolveResult, StaticProblem, solve_refined, unpack_solve
from .solver import pcg_solve

__all__ = [
    "SolveResult",
    "StaticProblem",
    "direct_solve",
    "element_stiffness",
    "plane_strain_stiffness",
    "pcg_solve",
    "solve_refined",
    "unpack_solve",
]
