"""Datagen orchestrator: random plates -> meshes -> FEM solves -> images,
the port of fea_tpu/datagen/pipeline.py (the sequential path).

The replacement for the reference's generate loop
(datagen/generate.py:12-171): same on-disk contract, but
  * meshing via the native CDT library instead of gmsh,
  * one PCG solve per condition (linear => per-step fields are scaled
    copies) instead of n_step sparse LU factorizations,
  * one pixel map per plate feeding every image instead of a VTK render
    per image,
  * failure handling preserved: solver failure -> clear dir + resample
    condition; degenerate geometry -> redraw plate.
"""

import os
from timeit import default_timer as timer
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..fem import StaticProblem
from ..fem.problem import _require_true_f32
from ..geometry import GeometryError, GeometrySampler
from ..mesh import Mesh, MeshError, triangulate_polygon, write_vtk
from ..raster import (
    build_pixel_map,
    field_image,
    geometry_image,
    node_splat_image,
    outline_image,
    region_image,
    scalar_range,
)
from ..raster.rasterizer import cell_field_image
from ..utils.device import resolve_device
from .conditions import ConditionSampler
from .writers import (
    append_region_value,
    clear_directory,
    domain_vtk_name,
    save_gray_png,
    verify_directory,
)

# Static-shape buckets (geometric-ish ladder): meshes are padded up to the
# next bucket so every plate in a bucket shares one set of solve shapes.
SHAPE_BUCKETS = [
    256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096, 6144, 8192,
    12288, 16384, 24576, 32768, 49152, 65536, 98304, 131072,
]


def next_bucket(n: int) -> int:
    for b in SHAPE_BUCKETS:
        if b >= n:
            return b
    return n


# Datagen acceptance threshold on the true relative residual. Measured
# against f64 SuperLU ground truth, the two-level-preconditioned f32 CG at
# residual 2e-3 still delivers displacement fields with relative MAE
# <= ~7e-5 (max-norm <= ~2e-3) — well under the 1/255 quantization of the
# uint8 dataset images and under what the reference's own PNG round trip
# preserves. A 1e-4 threshold resampled ~half of all hard-but-valid
# conditions (a throughput disaster AND a dataset bias the reference's
# direct LU does not have).
DATAGEN_ACCEPT_TOL = 2e-3


def solve_condition(mesh, condition, num_steps, pad: bool = True, **solve_kw):
    """Build + solve one condition, optionally bucket-padded; results are
    sliced back to the real node/triangle counts. Structurally singular
    systems short-circuit to a failed result without touching the device
    (the reference burns a full LU factorization to find out). `solve_kw`
    goes to StaticProblem.solve (its `device`: the CUDA device unless
    named)."""
    problem = StaticProblem.from_condition(
        mesh,
        material_regions=condition["material_regions"],
        point_constraints=condition["point_constraints"],
        edge_constraints=condition["edge_constraints"],
        point_forces=condition["point_forces"],
        edge_forces=condition["edge_forces"],
        num_steps=num_steps,
    )
    n, m = mesh.num_nodes, mesh.num_triangles
    if problem.structurally_singular():
        zeros_u = np.zeros((num_steps, n, 2))
        zeros_c = np.zeros((num_steps, m, 3))
        from ..fem.problem import SolveResult

        return SolveResult(
            displacements=zeros_u,
            strain=zeros_c,
            stress=zeros_c,
            converged=np.asarray(False),
            failed=np.asarray(True),
            residual_norm=np.asarray(np.inf),
            iterations=np.asarray(0),
        )
    if pad:
        problem = problem.padded(next_bucket(n + 3), next_bucket(m))
    # Packed single-step solve: ONE device->host fetch of one flat array;
    # the per-step expansion (linear scaling) happens on the host.
    from ..fem.problem import unpack_solve

    solve_kw.setdefault("accept_tol", DATAGEN_ACCEPT_TOL)
    packed = problem.solve(packed=True, **solve_kw).cpu().numpy()
    result = unpack_solve(
        packed, len(problem.coords), len(problem.triangles), num_steps
    )
    if pad:
        result = result._replace(
            displacements=result.displacements[:, :n],
            strain=result.strain[:, :m],
            stress=result.stress[:, :m],
        )
    return result


def _write_condition(
    mesh: Mesh,
    pixel_map,
    condition: Dict,
    result,
    condition_dir: str,
    num_steps: int,
    save_displacement: bool,
    save_strain: bool,
    save_stress: bool,
    save_meshes: bool,
    device=None,
) -> None:
    """One condition's files; the nodal images are interpolated on
    `device` (the CUDA device unless named)."""
    coords, tris = mesh.coords, mesh.triangles

    # magnitudes.txt + force-region images (reference fea_analysis.py:76-124)
    mag_path = os.path.join(condition_dir, "magnitudes.txt")
    for i, (v, (fx, fy)) in enumerate(condition["point_forces"]):
        append_region_value(mag_path, f"VertexForce{i}", (fx, fy))
        save_gray_png(
            os.path.join(condition_dir, f"regions_VertexForce{i}.png"),
            node_splat_image(pixel_map, coords, np.array([v])),
        )
    for i, (edge, (fx, fy)) in enumerate(condition["edge_forces"]):
        nodes = mesh.nodes_on_edge(edge)
        k = max(len(nodes), 1)
        append_region_value(mag_path, f"EdgeForce{i}", (fx / k, fy / k))
        save_gray_png(
            os.path.join(condition_dir, f"regions_EdgeForce{i}.png"),
            node_splat_image(pixel_map, coords, nodes),
        )

    # constraint-region images
    for i, v in enumerate(condition["point_constraints"]):
        save_gray_png(
            os.path.join(condition_dir, f"regions_VertexConstraint{i}.png"),
            node_splat_image(pixel_map, coords, np.array([v])),
        )
    for i, edge in enumerate(condition["edge_constraints"]):
        save_gray_png(
            os.path.join(condition_dir, f"regions_EdgeConstraint{i}.png"),
            node_splat_image(pixel_map, coords, mesh.nodes_on_edge(edge)),
        )

    # materials.txt + material-region images
    mat_path = os.path.join(condition_dir, "materials.txt")
    for i, ((young, poisson), node_ids) in enumerate(condition["material_regions"]):
        append_region_value(
            mat_path, f"MaterialRegion{i}", (float(young), float(poisson))
        )
        save_gray_png(
            os.path.join(condition_dir, f"regions_MaterialRegion{i}.png"),
            region_image(pixel_map, tris, node_ids, mesh.num_nodes),
        )

    # outputs + ranges.txt (step-1 image only; per-step ranges recorded —
    # reference fea_analysis.py:560-609)
    u = np.asarray(result.displacements)  # (num_steps, N, 2)
    strain = np.asarray(result.strain)
    stress = np.asarray(result.stress)
    field_config: List[Tuple[str, np.ndarray, bool]] = []
    if save_displacement:
        field_config += [
            ("displacement_x", u[..., 0], True),
            ("displacement_y", u[..., 1], True),
        ]
    if save_stress:
        field_config += [
            ("stress_x", stress[..., 0], False),
            ("stress_y", stress[..., 1], False),
        ]
    if save_strain:
        field_config += [
            ("strain_x", strain[..., 0], False),
            ("strain_y", strain[..., 1], False),
        ]

    ranges_path = os.path.join(condition_dir, "ranges.txt")
    for step in range(1, num_steps):
        for name, data, nodal in field_config:
            lo, hi = scalar_range(data[step])
            append_region_value(ranges_path, f"{name}_{step}", (lo, hi))
            if step == 1:
                img = (
                    field_image(pixel_map, tris, data[step], (lo, hi), device=device)
                    if nodal
                    else cell_field_image(pixel_map, data[step], (lo, hi))
                )
                save_gray_png(
                    os.path.join(condition_dir, f"outputs_{name}.png"), img
                )

    if save_meshes:
        for step in range(num_steps):
            write_vtk(
                os.path.join(condition_dir, domain_vtk_name(step, num_steps)),
                coords,
                tris,
                point_data={"u": u[step]},
                cell_data={
                    "cauchy_strain": strain[step],
                    "cauchy_stress": stress[step],
                },
            )


def generate_data(
    data_dir: str = "data/",
    image_size: int = 512,
    num_plates: int = 1,
    start_plate: Optional[int] = None,
    conditions_per_plate: int = 4,
    mesh_size: float = 1e-2,
    num_polygons_range: Tuple[int, int] = (1, 3),
    points_per_polygon_range: Tuple[int, int] = (3, 8),
    holes_per_polygon_range: Tuple[int, int] = (0, 3),
    points_per_hole_range: Tuple[int, int] = (3, 4),
    num_regions: Tuple[int, int] = (1, 5),
    save_displacement: bool = True,
    save_strain: bool = False,
    save_stress: bool = False,
    num_steps_per_condition: int = 11,
    save_meshes: bool = False,
    seed: Optional[int] = None,
    solver_tol: Optional[float] = None,
    solver_max_iters: int = 6000,
    max_condition_retries: int = 20,
    pad_to_buckets: bool = True,
    wandb_inject_function: Optional[Callable] = None,
    verbose: bool = True,
    device=None,
) -> Dict:
    """Sequential single-host datagen (the batched path lives in
    datagen.batched). Solves and nodal images run on `device`, the CUDA
    device unless the caller names another. Returns summary stats."""
    assert num_steps_per_condition > 1, "Must have at least 2 steps per condition."
    device = resolve_device(device)
    _require_true_f32()
    verify_directory(data_dir)

    geometry_sampler = GeometrySampler(
        num_polygons_range=num_polygons_range,
        points_per_polygon_range=points_per_polygon_range,
        holes_per_polygon_range=holes_per_polygon_range,
        points_per_hole_range=points_per_hole_range,
        random_seed=seed,
    )
    condition_sampler = ConditionSampler(
        num_regions_range=num_regions,
        random_seed=None if seed is None else seed + 1,
    )

    assert num_plates >= 1 and conditions_per_plate >= 1
    plate_index = (start_plate - 1) if start_plate is not None else 0
    total_time = 0.0
    stats = {"solves": 0, "failures": 0}

    from .batched import PlateSolver, RunningBuckets

    include_cell_fields = save_strain or save_stress or save_meshes
    # Monotone running-max buckets: after the first few plates every solve
    # shares one padded shape (the port keeps fea_tpu's policy, so the same
    # seed gives the same plates and the same padding).
    buckets = RunningBuckets()

    def nonsingular_condition(solver, condition, retries_box):
        """Resample past structurally singular conditions (instant host
        check — the reference pays an LU to find its NaNs). Returns
        (condition, problem) or None to abandon the plate."""
        while True:
            problem = solver.build_problem(condition)
            if not problem.structurally_singular():
                return condition, problem
            stats["solves"] += 1
            stats["failures"] += 1
            retries_box[0] += 1
            if retries_box[0] > max_condition_retries:
                return None
            condition = condition_sampler.sample_one(solver.mesh)

    def prepare_plate():
        """Host-side prep of one plate: geometry -> mesh -> non-singular
        conditions -> pixel map. Plates are iid, so preps are index-free."""
        while True:
            try:
                polygon = geometry_sampler.generate()
                mesh = triangulate_polygon(polygon, mesh_size=mesh_size)
            except (GeometryError, MeshError):
                continue
            buckets.update([mesh])
            solver = PlateSolver(
                mesh,
                num_steps_per_condition,
                tol=solver_tol,
                max_iters=solver_max_iters,
                include_cell_fields=include_cell_fields,
                node_bucket=buckets.node,
                tri_bucket=buckets.tri,
                min_incidence_degree=buckets.degree,
                device=device,
            )
            buckets.update_degree([solver])
            conditions = condition_sampler.sample(mesh, conditions_per_plate)
            retries_box = [0]
            pending = []
            ok = True
            for i, condition in enumerate(conditions):
                out = nonsingular_condition(solver, condition, retries_box)
                if out is None:
                    ok = False
                    break
                pending.append((i, out[0], out[1]))
            if not ok:
                continue
            pixel_map = build_pixel_map(
                mesh.coords,
                mesh.triangles,
                image_size,
                pad_candidates=32,
                pad_shapes=(buckets.node, buckets.tri),
            )
            return mesh, solver, pending, pixel_map, retries_box

    # Software-pipelined loop: while plate k's solves run on the device,
    # the host prepares plate k+1 (mesh, clustering, pixel map) — the fetch
    # latency is hidden behind the next plate's prep.
    next_prep = prepare_plate()
    while plate_index < num_plates:
        mesh, solver, pending, pixel_map, retries_box = next_prep

        start = timer()
        batch_problems = [p for _, _, p in pending]
        while len(batch_problems) < conditions_per_plate:
            batch_problems.append(batch_problems[-1])
        token = solver.dispatch_batch(batch_problems)

        if plate_index + 1 < num_plates:
            next_prep = prepare_plate()  # overlaps the device solves
        else:
            next_prep = None

        results = solver.fetch_batch(token)[: len(pending)]
        elapsed = timer() - start
        stats["solves"] += len(pending)
        total_time += elapsed
        if verbose:
            print("TIME:", elapsed)

        # Retry CG-level failures (near-singular systems) synchronously.
        final: Dict[int, Tuple] = {}
        abandon_plate = False
        while pending:
            retry: List = []
            for (slot, condition, _problem), result in zip(pending, results):
                if result.success:
                    final[slot] = (condition, result)
                    continue
                stats["failures"] += 1
                if verbose:
                    print(
                        f"Failed to calculate for plate {plate_index + 1} "
                        f"condition {slot + 1}; regenerating condition"
                    )
                out = nonsingular_condition(
                    solver, condition_sampler.sample_one(mesh), retries_box
                )
                if out is None:
                    abandon_plate = True
                    break
                retry.append((slot, out[0], out[1]))
            pending = retry
            if abandon_plate or not pending:
                break
            start = timer()
            batch_problems = [p for _, _, p in pending]
            while len(batch_problems) < conditions_per_plate:
                batch_problems.append(batch_problems[-1])
            token = solver.dispatch_batch(batch_problems)
            results = solver.fetch_batch(token)[: len(pending)]
            total_time += timer() - start
            stats["solves"] += len(pending)

        if abandon_plate:
            # unsatisfiable plate: promote the prepared next plate to this
            # index (plates are iid) and prepare a fresh next
            if next_prep is None:
                next_prep = prepare_plate()
            continue

        plate_dir = os.path.join(data_dir, str(plate_index + 1))
        verify_directory(plate_dir)
        save_gray_png(
            os.path.join(plate_dir, "outline.png"),
            outline_image(pixel_map, mesh.coords, mesh.ring_corner_ids),
        )
        save_gray_png(
            os.path.join(plate_dir, "input.png"), geometry_image(pixel_map)
        )
        for slot in sorted(final):
            condition, result = final[slot]
            condition_dir = os.path.join(plate_dir, str(slot + 1))
            verify_directory(condition_dir)
            clear_directory(condition_dir)
            _write_condition(
                mesh,
                pixel_map,
                condition,
                result,
                condition_dir,
                num_steps_per_condition,
                save_displacement,
                save_strain,
                save_stress,
                save_meshes,
                device=device,
            )

        if wandb_inject_function is not None:
            wandb_inject_function(plate_index, total_time, None)
        plate_index += 1
        if verbose:
            print("PLATE TIME:", total_time)
        if next_prep is None and plate_index < num_plates:
            next_prep = prepare_plate()

    if verbose:
        print("TOTAL TIME:", total_time)
    return {
        "plates": num_plates,
        "solves": stats["solves"],
        "failures": stats["failures"],
        "total_solve_time": total_time,
    }
