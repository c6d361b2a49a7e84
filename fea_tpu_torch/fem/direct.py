"""Host-side f64 direct solve — the fallback lane for terminal CG
failures; the port's own copy of fea_tpu/fem/direct.py (NumPy and SciPy).

The reference's datagen keeps EVERY finite SuperLU solve and resamples
only on NaN (datagen/fea_analysis.py:455-461). The device PCG, by
contrast, terminally fails some oracle-solvable ill-conditioned
conditions, and resampling those thins the data distribution in the
ill-conditioned tail relative to the reference's.

This module closes that gap: when a solve blows its whole CG budget, the
caller hands the condition to `direct_solve` — the same f64 SuperLU
factorization sfepy's ls.scipy_direct uses — on the host. It is also what
the device solves are held against.
"""

from typing import Optional, Tuple

import numpy as np

from .assembly import assemble_scipy_csr
from .elasticity import element_stiffness_np
from .problem import SolveResult, StaticProblem


def direct_solve_u1(
    problem: StaticProblem,
) -> Tuple[Optional[np.ndarray], bool, bool]:
    """f64 SuperLU on the Dirichlet-reduced system.

    Returns (u (N,2) or None, finite, bounded). `finite` is the
    reference's exact acceptance bar (np.isnan check only,
    fea_analysis.py:455-461); `bounded` additionally caps |u| at 1e6
    (a finite-but-astronomical solve like the composite app fixture's
    1e10 ranges passes the reference's bar).
    """
    import warnings

    import scipy.sparse.linalg as spla

    n = len(problem.coords)
    Ke, _B, _D, _area = element_stiffness_np(
        problem.coords, problem.triangles, problem.young, problem.poisson
    )
    K = assemble_scipy_csr(Ke, problem.triangles, n)
    free = ~np.repeat(problem.fixed_nodes, 2)
    b = problem.loads.reshape(-1).astype(np.float64)
    K_ff = K[free][:, free].tocsc()
    u = np.zeros(2 * n)
    with warnings.catch_warnings():
        # SuperLU warns MatrixRankWarning on exact singularity and
        # returns inf/nan — exactly the reference's failure signature
        warnings.simplefilter("ignore")
        try:
            u_f = spla.spsolve(K_ff, b[free])
        except Exception:
            return None, False, False
    u[free] = u_f
    finite = bool(np.isfinite(u_f).all())
    bounded = finite and bool(np.abs(u_f).max() <= 1e6)
    if not finite:
        return None, False, False
    return u.reshape(n, 2), finite, bounded


def direct_solve(problem: StaticProblem) -> Optional[SolveResult]:
    """Full fallback solve: f64 SuperLU + the linear load ramp.

    Returns a SolveResult matching the device kernel's contract
    (u(t_k) = t_k * u1, el_avg constant-strain eps/sig, steps on
    np.linspace(0, 1, num_steps)) or None when the solve is non-finite
    — the one case where the reference would also resample.
    """
    u1, finite, _bounded = direct_solve_u1(problem)
    if u1 is None or not finite:
        return None
    _Ke, B, D, _area = element_stiffness_np(
        problem.coords, problem.triangles, problem.young, problem.poisson
    )
    eps1 = np.einsum("mij,mj->mi", B, u1[problem.triangles].reshape(-1, 6))
    sig1 = np.einsum("mij,mj->mi", D, eps1)
    t = np.linspace(0.0, 1.0, problem.num_steps)
    return SolveResult(
        displacements=t[:, None, None] * u1[None],
        strain=t[:, None, None] * eps1[None],
        stress=t[:, None, None] * sig1[None],
        converged=np.asarray(True),
        failed=np.asarray(False),
        residual_norm=np.asarray(0.0),
        iterations=np.asarray(0),
    )
