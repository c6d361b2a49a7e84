"""In-memory datagen -> training bridge (the fused fast path), the port of
fea_tpu/data/arrays.py.

The reference's two halves communicate only through PNG files on disk
(SURVEY.md §1): solve -> VTK -> render -> PNG -> decode -> resize ->
tensors. This module produces training samples directly from solved
fields at the target resolution, applying the exact FEADataset
normalization contract (including 8-bit quantization of the displacement
images, so the training distribution matches the PNG path) with zero
filesystem traffic.
"""

from typing import Dict, List, Optional

import numpy as np

from ..datagen.batched import PlateSolver
from ..datagen.conditions import ConditionSampler
from ..geometry import GeometryError, GeometrySampler
from ..mesh import MeshError, triangulate_polygon
from ..raster import (
    build_pixel_map,
    field_image,
    geometry_image,
    node_splat_image,
    region_image,
    scalar_range,
)
from ..utils.device import resolve_device
from .dataset import to_signed


def _binarize_img(img: np.ndarray) -> np.ndarray:
    return (img < 128).astype(np.float32)


def condition_to_samples(
    mesh,
    pixel_map,
    condition: Dict,
    result,
    num_steps: int,
    image_size: int,
    device=None,
) -> List[Dict[str, np.ndarray]]:
    """All training samples (steps 1..num_steps-1) for one solved condition,
    matching FEADataset.__getitem__'s tensors (model/diffusion.py:105-380).
    The displacement images are interpolated on `device` (the CUDA device
    unless named)."""
    tris = mesh.triangles
    geometry01 = _binarize_img(geometry_image(pixel_map))

    constraints = np.zeros_like(geometry01)
    for v in condition["point_constraints"]:
        constraints += _binarize_img(
            node_splat_image(pixel_map, mesh.coords, np.array([v]))
        )
    for edge in condition["edge_constraints"]:
        constraints += _binarize_img(
            node_splat_image(pixel_map, mesh.coords, mesh.nodes_on_edge(edge))
        )
    constraints01 = (constraints > 0.5).astype(np.float32)

    # per-force masks + divided magnitudes (edge loads split per node —
    # the magnitudes.txt contract)
    force_entries = []
    for edge, (fx, fy) in condition["edge_forces"]:
        nodes = mesh.nodes_on_edge(edge)
        k = max(len(nodes), 1)
        mask = _binarize_img(
            node_splat_image(pixel_map, mesh.coords, nodes)
        )
        force_entries.append(("Edge", mask, (fx / k, fy / k)))
    for v, (fx, fy) in condition["point_forces"]:
        mask = _binarize_img(
            node_splat_image(pixel_map, mesh.coords, np.array([v]))
        )
        force_entries.append(("Vertex", mask, (fx, fy)))

    materials = np.zeros((image_size, image_size, 2), np.float32)
    for (young, poisson), node_ids in condition["material_regions"]:
        mask = _binarize_img(
            region_image(pixel_map, tris, node_ids, mesh.num_nodes)
        )
        if mask.sum() == 0:
            mask = geometry01
        young_n = np.sign(young) * np.log1p(abs(float(young)))
        layer = np.stack(
            [mask * float(young_n), mask * float(poisson)], axis=-1
        )
        materials = np.where(layer != 0, layer, materials)

    u = np.asarray(result.displacements)  # (num_steps, N, 2)
    lo_x, hi_x = scalar_range(u[1, :, 0])
    lo_y, hi_y = scalar_range(u[1, :, 1])
    disp_imgs = []
    for channel, (lo, hi) in ((0, (lo_x, hi_x)), (1, (lo_y, hi_y))):
        img = field_image(pixel_map, tris, u[1, :, channel], (lo, hi), device=device)
        # dataset decode: /255 -> invert -> [-1,1]
        disp_imgs.append(to_signed(1.0 - img.astype(np.float32) / 255.0))
    displacement = np.stack(disp_imgs, axis=-1)

    samples = []
    n_steps = num_steps - 1
    for step in range(1, num_steps):
        force = np.zeros((image_size, image_size, 2), np.float32)
        for _kind, mask, (fx, fy) in force_entries:
            factor = (step - 1) / n_steps
            norm = [
                np.sign(v) * np.log1p(abs(float(v)) * factor) for v in (fx, fy)
            ]
            layer = np.stack([mask * norm[0], mask * norm[1]], axis=-1)
            force = np.where(layer != 0, layer, force)

        t_k = step / (num_steps - 1)
        ranges = np.asarray(
            [t_k * lo_x, t_k * hi_x, t_k * lo_y, t_k * hi_y], np.float32
        )
        samples.append(
            {
                "geometry": to_signed(geometry01)[..., None],
                "displacement": displacement.astype(np.float32),
                "constraints": to_signed(constraints01)[..., None],
                # float32 like every other tensor (NumPy 2 keeps the f64 of
                # the log-scaled magnitudes; the trainer takes f32)
                "forces": force.astype(np.float32),
                "materials": materials,
                "displacement_range": ranges,
                "log_displacement_range": np.log1p(np.abs(ranges)).astype(
                    np.float32
                ),
                "sign_displacement_range": (ranges >= 0).astype(np.float32),
            }
        )
    return samples


class InMemoryFEADataset:
    """FEADataset-compatible view over generated in-memory samples."""

    def __init__(
        self, samples: List[Dict], conditions_per_plate: int, num_steps: int
    ):
        self.samples = samples
        self.conditions_per_plate_geometry = conditions_per_plate
        self.num_steps = num_steps - 1

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        return self.samples[index]

    @classmethod
    def generate(
        cls,
        num_plates: int = 1,
        conditions_per_plate: int = 4,
        num_steps: int = 6,
        image_size: int = 256,
        mesh_size: float = 1e-2,
        seed: Optional[int] = None,
        max_condition_retries: int = 30,
        device=None,
        **geometry_kw,
    ) -> "InMemoryFEADataset":
        """Samples of `num_plates` plates solved and rasterized on
        `device`, the CUDA device unless the caller names another."""
        device = resolve_device(device)
        geometry_sampler = GeometrySampler(
            random_seed=seed, **geometry_kw
        )
        condition_sampler = ConditionSampler(
            random_seed=None if seed is None else seed + 1
        )
        samples: List[Dict] = []
        plates = 0
        while plates < num_plates:
            try:
                polygon = geometry_sampler.generate()
                mesh = triangulate_polygon(polygon, mesh_size=mesh_size)
            except (GeometryError, MeshError):
                continue
            solver = PlateSolver(mesh, num_steps, device=device)
            pixel_map = build_pixel_map(
                mesh.coords, mesh.triangles, image_size, pad_candidates=32
            )
            got = 0
            retries = 0
            abandoned = False
            while got < conditions_per_plate:
                condition = condition_sampler.sample_one(mesh)
                problem = solver.build_problem(condition)
                if problem.structurally_singular():
                    retries += 1
                    if retries > max_condition_retries:
                        abandoned = True
                        break
                    continue
                result = solver.fetch(solver.dispatch(problem))
                if not result.success:
                    retries += 1
                    if retries > max_condition_retries:
                        abandoned = True
                        break
                    continue
                samples.extend(
                    condition_to_samples(
                        mesh, pixel_map, condition, result, num_steps, image_size,
                        device=device,
                    )
                )
                got += 1
            if abandoned:
                continue
            plates += 1
        return cls(samples, conditions_per_plate, num_steps)
