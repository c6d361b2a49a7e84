"""End-to-end application workflow, the port of fea_tpu/apps/runner.py.

The CLI equivalent of the reference's notebook pipeline
(test_nbs/generateapplication.ipynb): solve the application problem,
render outline / geometry / constraint / force / displacement images
(displacement at the fixed +-0.05 decode scale the metrics assume),
optionally run a trained FDN-UNet surrogate on the rendered inputs, and
score the prediction against the ground-truth solve. The solve, the field
images and the surrogate run on `device`, the CUDA device unless the
caller names another; meshing, the other images and the scoring are host
NumPy, as in fea_tpu.
"""

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data.dataset import to_signed
from ..datagen.pipeline import next_bucket
from ..datagen.writers import append_region_value, save_gray_png, verify_directory
from ..fem import StaticProblem, solve_refined
from ..fem.problem import element_materials
from ..mesh import Mesh, read_medit_mesh, triangulate, write_vtk
from ..metrics.accuracy import accuracy_for_one_sample, predicted_displacement_at_nodes
from ..models.fdnunet import build_models, predict
from ..raster import (
    build_pixel_map,
    field_image,
    geometry_image,
    interpolate_field,
    node_splat_image,
    outline_image,
    scalar_range,
)
from ..utils.device import resolve_device
from ..utils.precision import model_precision
from .specs import APPLICATIONS, ApplicationSpec


def _facet_nodes(coords, triangles, candidate_mask):
    """sfepy facet-region rule: vertices of triangle edges whose endpoints
    both satisfy the predicate."""
    tri = np.asarray(triangles)
    keep = np.zeros(len(coords), dtype=bool)
    for e in range(3):
        a = tri[:, e]
        b = tri[:, (e + 1) % 3]
        both = candidate_mask[a] & candidate_mask[b]
        keep[a[both]] = True
        keep[b[both]] = True
    return keep


def _nearest_node(coords, point, tol=1e-6):
    d = np.linalg.norm(coords - np.asarray(point), axis=1)
    idx = int(d.argmin())
    if d[idx] >= max(tol, 1e-3):
        raise ValueError(f"no node near {point} (closest {d[idx]:.2e})")
    return idx


def _collinear_nodes(coords, p0, p1, tol=1e-9):
    p0 = np.asarray(p0)
    p1 = np.asarray(p1)
    d = p1 - p0
    rel = coords - p0
    cross = np.abs(d[0] * rel[:, 1] - d[1] * rel[:, 0])
    return np.where(cross < tol)[0]


def build_problem(spec: ApplicationSpec, mesh: Mesh) -> StaticProblem:
    coords = mesh.coords
    sign = -1.0 if spec.negate_loads else 1.0

    fixed = np.zeros(mesh.num_nodes, dtype=bool)
    for pred in spec.constraint_predicates:
        fixed |= _facet_nodes(coords, mesh.triangles, pred(coords))
    for v in spec.constraint_vertices:
        fixed[_nearest_node(coords, v)] = True

    loads = np.zeros((mesh.num_nodes, 2))
    for load in spec.loads:
        val = sign * np.asarray(load.value)
        if load.vertex is not None:
            loads[_nearest_node(coords, load.vertex)] += val
        elif load.predicate is not None:
            nodes = np.where(_facet_nodes(coords, mesh.triangles, load.predicate(coords)))[0]
            loads[nodes] += val  # dw_point_load: value at every region vertex
        elif load.collinear is not None:
            loads[_collinear_nodes(coords, *load.collinear)] += val

    if spec.material_regions is not None:
        regions = [
            ((m.young, m.poisson), np.where(m.predicate(coords))[0])
            for m in spec.material_regions
        ]
        young, poisson = element_materials(mesh.triangles, mesh.num_nodes, regions)
    else:
        young = np.full(mesh.num_triangles, spec.young)
        poisson = np.full(mesh.num_triangles, spec.poisson)

    return StaticProblem(
        coords=np.asarray(coords),
        triangles=np.asarray(mesh.triangles),
        young=young,
        poisson=poisson,
        fixed_nodes=fixed,
        loads=loads,
        num_steps=spec.num_steps,
    )


def load_app_mesh(spec: ApplicationSpec) -> Mesh:
    """The reference's MEDIT fixture where it is mounted, else the CDT
    mesher's mesh of the spec's polygon."""
    if spec.mesh_fixture and os.path.isfile(spec.mesh_fixture):
        coords, tris = read_medit_mesh(spec.mesh_fixture)
        return Mesh(coords=coords, triangles=tris)
    return triangulate(spec.polygon, mesh_size=spec.mesh_size)


def run_application(
    name: str,
    output_dir: str = "app_output",
    image_size: int = 512,
    checkpoint: Optional[str] = None,
    decode_scale: float = 0.05,
    use_ema: bool = False,
    device=None,
) -> Dict:
    """Solve, render and score the application `name` into `output_dir`;
    with `checkpoint` (a directory holding the port's `state.pt`) also
    predict it with the regression surrogate and score the prediction."""
    device = resolve_device(device)
    spec = APPLICATIONS[name]
    verify_directory(output_dir)

    mesh = load_app_mesh(spec)
    problem = build_problem(spec, mesh)
    result = solve_refined(
        problem,
        pad_buckets=(next_bucket(mesh.num_nodes + 3), next_bucket(mesh.num_triangles)),
        device=device,
    )
    u = np.asarray(result.displacements[-1])

    # ---- renders (same framing/colormap semantics as datagen) -----------
    pixel_map = build_pixel_map(mesh.coords, mesh.triangles, image_size)
    save_gray_png(os.path.join(output_dir, "geometry.png"), geometry_image(pixel_map))
    if mesh.ring_corner_ids:
        save_gray_png(
            os.path.join(output_dir, "outline.png"),
            outline_image(pixel_map, mesh.coords, mesh.ring_corner_ids),
        )
    save_gray_png(
        os.path.join(output_dir, "constraint.png"),
        node_splat_image(pixel_map, mesh.coords, np.where(problem.fixed_nodes)[0]),
    )
    save_gray_png(
        os.path.join(output_dir, "force.png"),
        node_splat_image(
            pixel_map, mesh.coords, np.where((problem.loads != 0).any(axis=1))[0]
        ),
    )
    for axis, channel in (("x", 0), ("y", 1)):
        save_gray_png(
            os.path.join(output_dir, f"displacement_{axis}.png"),
            field_image(
                pixel_map,
                mesh.triangles,
                u[:, channel],
                value_range=(-decode_scale, decode_scale),
                device=device,
            ),
        )
        lo, hi = scalar_range(u[:, channel])
        append_region_value(
            os.path.join(output_dir, "ranges.txt"), f"displacement_{axis}_1", (lo, hi)
        )

    vtk_path = os.path.join(output_dir, f"{name}.vtk")
    write_vtk(vtk_path, mesh.coords, mesh.triangles, point_data={"u": u})

    out: Dict = {
        "name": name,
        "nodes": mesh.num_nodes,
        "triangles": mesh.num_triangles,
        "residual_norm": float(result.residual_norm),
        "converged": bool(result.converged),
        "u_min": float(u.min()),
        "u_max": float(u.max()),
        "vtk": vtk_path,
    }

    # ---- ground-truth self-consistency: rasterize -> metrics sampler ----
    gt_metrics = accuracy_for_one_sample(
        vtk_path,
        os.path.join(output_dir, "displacement_x.png"),
        os.path.join(output_dir, "displacement_y.png"),
        os.path.join(output_dir, "geometry.png"),
        image_size=image_size,
        clip=decode_scale,
    )
    out["raster_roundtrip_mae"] = gt_metrics[0]

    # ---- optional surrogate prediction -----------------------------------
    if checkpoint is not None:
        out.update(predict_with_surrogate(
            spec, mesh, problem, output_dir, image_size, checkpoint, decode_scale,
            use_ema=use_ema, device=device,
        ))
    return out


@model_precision()
def predict_with_surrogate(
    spec, mesh, problem, output_dir, image_size, checkpoint, decode_scale,
    use_ema: bool = False, device=None,
) -> Dict:
    """Run a trained FDN-UNet on the app's rendered inputs
    (generateapplication.ipynb cells 8-18) and score it.

    `checkpoint` is a directory holding `state.pt` as the port's
    `Trainer.save_checkpoint` writes it (`results/model-<milestone>`); a
    checkpoint of fea_tpu's Trainer (orbax) reaches the port through
    `tools/convert_orbax_checkpoint.py`. The model's widths are
    `TrainerConfig`'s defaults, as in fea_tpu; its encoder and decoder are
    built without storage and take the checkpoint's weights (the EMA
    weights with `use_ema`, which raises when the checkpoint has none)."""
    from ..train.trainer import TrainerConfig

    device = resolve_device(device)
    t_start = time.perf_counter()

    # Build model inputs with the dataset normalization contract.
    model_size = 256
    pm = build_pixel_map(mesh.coords, mesh.triangles, model_size)
    geometry01 = (geometry_image(pm) < 128).astype(np.float32)
    constraints01 = (
        node_splat_image(pm, mesh.coords, np.where(problem.fixed_nodes)[0]) < 128
    ).astype(np.float32)

    forces = np.zeros((model_size, model_size, 2), np.float32)
    for node in np.where((problem.loads != 0).any(axis=1))[0]:
        mask = (node_splat_image(pm, mesh.coords, np.array([node])) < 128).astype(np.float32)
        mag = problem.loads[node]
        norm = np.sign(mag) * np.log1p(np.abs(mag))
        layer = np.stack([mask * norm[0], mask * norm[1]], axis=-1)
        forces = np.where(layer != 0, layer, forces)

    young_vals = np.zeros(mesh.num_nodes)
    poisson_vals = np.zeros(mesh.num_nodes)
    if spec.material_regions is not None:
        for m in spec.material_regions:
            sel = m.predicate(mesh.coords)
            young_vals[sel] = m.young
            poisson_vals[sel] = m.poisson
    else:
        young_vals[:] = spec.young
        poisson_vals[:] = spec.poisson
    young_img = interpolate_field(pm, mesh.triangles, np.log1p(young_vals), device).cpu().numpy()
    poisson_img = interpolate_field(pm, mesh.triangles, poisson_vals, device).cpu().numpy()
    materials = np.stack(
        [young_img * geometry01, poisson_img * geometry01], axis=-1
    ).astype(np.float32)

    # float32, as fea_tpu's arrays become on the device (the log-scaled
    # forces come out of NumPy as float64)
    batch = {
        "materials": materials[None],
        "conditions": np.concatenate(
            [forces[None], to_signed(constraints01)[None, ..., None]], axis=-1
        ).astype(np.float32),
        "geometry": to_signed(geometry01)[None, ..., None],
    }

    config = TrainerConfig()
    encoder, decoder, _ = build_models(
        input_dim=config.input_dim,
        image_height=model_size,
        image_width=model_size,
        num_channels=config.num_channels,
        num_auxiliary_condition_channels=config.num_auxiliary_condition_channels,
        num_stages=config.num_stages,
    )
    state = torch.load(
        os.path.join(checkpoint, "state.pt"), map_location="cpu", mmap=True, weights_only=True
    )
    # EMA weights option: the reference notebooks load checkpoints into an
    # ema_pytorch.EMA wrapper (generateapplication.ipynb cell 16)
    weights = state["params"]
    if use_ema:
        weights = state["ema_params"]
        if weights is None:
            raise ValueError(
                "use_ema requested but the checkpoint holds no EMA weights "
                "(train with --use_ema_model)"
            )
    for key, module in (("encoder", encoder), ("decoder", decoder)):
        module.to_empty(device=device)
        module.load_state_dict(weights[key])  # strict: names and shapes
        module.eval()

    t_weights = time.perf_counter()
    image = predict(
        encoder, decoder, *(torch.from_numpy(batch[k]).to(device)
                            for k in ("materials", "conditions", "geometry"))
    )
    image = image.cpu().numpy()[0]
    t_predicted = time.perf_counter()

    for axis, ch in (("x", 0), ("y", 1)):
        img = np.round((1.0 - (image[:, :, ch] + 1.0) / 2.0) * 255).astype(np.uint8)
        save_gray_png(os.path.join(output_dir, f"predicted_displacement_{axis}.png"), img)

    mae, mse, rmse = accuracy_for_one_sample(
        os.path.join(output_dir, f"{spec.name}.vtk"),
        os.path.join(output_dir, "predicted_displacement_x.png"),
        os.path.join(output_dir, "predicted_displacement_y.png"),
        os.path.join(output_dir, "geometry.png"),
        image_size=model_size,
        clip=decode_scale,
    )

    # Write predictions back onto the mesh as a VTK (the reference's
    # save_pred_disp_mesh notebook, test_nbs/save_pred_disp_mesh.ipynb).
    pred_nodes = predicted_displacement_at_nodes(
        mesh.coords,
        os.path.join(output_dir, "predicted_displacement_x.png"),
        os.path.join(output_dir, "predicted_displacement_y.png"),
        os.path.join(output_dir, "geometry.png"),
        image_size=model_size,
        decode_scale=decode_scale,
    )
    write_vtk(
        os.path.join(output_dir, "predicted.vtk"),
        mesh.coords,
        mesh.triangles,
        point_data={"u": pred_nodes},
    )
    t_end = time.perf_counter()
    return {
        "pred_mae": mae,
        "pred_mse": mse,
        "pred_rmse": rmse,
        # end-to-end serve timing: rendering the model inputs from the
        # mesh, checkpoint load, forward (incl. the kernels' nvcc build
        # where this checkout has not built them yet, and the fetch to the
        # host), PNG decode + scoring + VTK writeback
        "predict_wall_s": {
            "render_inputs_and_restore": round(t_weights - t_start, 2),
            "forward_incl_compile_and_fetch": round(t_predicted - t_weights, 2),
            "decode_score_writeback": round(t_end - t_predicted, 2),
            "total": round(t_end - t_start, 2),
        },
    }
