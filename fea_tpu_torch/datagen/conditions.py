"""Seeded boundary-condition sampler (the port's own copy of
fea_tpu/datagen/conditions.py: the same conditions from the same seed).

Behavioral re-implementation of MeshGenerator.sample_conditions
(mesh_generator.py:397-521):
  1. sample 1..E-1 boundary edges;
  2. constrain a random subset of them; the leftover endpoints of the
     *other* sampled edges become vertex constraints;
  3. point forces from the remaining corner vertices (can be empty),
     edge forces from the remaining edges (>= 1 force guaranteed);
  4. material regions must exactly cover all mesh nodes, and regions
     must receive *distinct* materials (the reference keys a dict by
     material tuple, so a duplicate draw collapses regions and trips the
     coverage check -> resample);
  5. conditions deduplicated;
  6. force magnitudes: +-U{1..1000} per axis.
"""

import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..materials import MATERIALS
from .regions import cluster_regions


class ConditionSampler:
    def __init__(
        self,
        num_regions_range: Tuple[int, int] = (1, 5),
        force_magnitude_range: Tuple[int, int] = (1, 1000),
        random_seed: Optional[int] = None,
        max_attempts_per_condition: int = 200,
    ):
        self.num_regions_range = num_regions_range
        self.force_magnitude_range = force_magnitude_range
        self.random = random.Random(random_seed)
        self.max_attempts = max_attempts_per_condition

    def sample(
        self,
        mesh,
        num_conditions: int = 4,
        cluster_pool: Optional[List] = None,
        reuse_probability: float = 0.8,
    ) -> List[Dict]:
        """Sample conditions against a mesh.Mesh's tag contract.

        `cluster_pool`, when given, is a per-plate cache of region
        partitions: fresh clusterings are appended to it, and subsequent
        draws reuse a cached partition with `reuse_probability`. Clustering
        is the dominant host cost of condition *re*-sampling (structurally
        singular draws are common — the reference solves them to NaN,
        fea_analysis.py:455-461, we reject on host), so retries shouldn't
        pay k-means again."""
        corner_ids = mesh.all_corner_ids()
        all_edges = mesh.all_edges()
        conditions: List[Dict] = []
        attempts = 0
        while len(conditions) < num_conditions:
            attempts += 1
            if attempts > self.max_attempts * num_conditions:
                raise RuntimeError("condition sampling did not converge")
            vertex_pool = list(corner_ids)
            edge_pool = list(all_edges)

            sampled_edges = self.random.sample(
                edge_pool, self.random.randint(1, max(len(edge_pool) - 1, 1))
            )
            vertices_on_sampled = set()
            for a, b in sampled_edges:
                vertices_on_sampled.add(a)
                vertices_on_sampled.add(b)

            edges_to_constrain = self.random.sample(
                sampled_edges, self.random.randint(1, len(sampled_edges))
            )
            vertices_to_constrain = set(vertices_on_sampled)
            for a, b in edges_to_constrain:
                vertices_to_constrain.discard(a)
                vertices_to_constrain.discard(b)

            for e in edges_to_constrain:
                edge_pool.remove(e)
            for v in vertices_on_sampled:
                vertex_pool.remove(v)

            if vertex_pool:
                point_forces = self.random.sample(
                    vertex_pool, self.random.randint(1, len(vertex_pool))
                )
            else:
                point_forces = []

            edge_forces = self.random.sample(
                edge_pool,
                self.random.randint(
                    0 if len(point_forces) >= 1 else 1, len(edge_pool)
                ),
            )

            if (
                cluster_pool
                and self.random.random() < reuse_probability
            ):
                regions = self.random.choice(cluster_pool)
            else:
                regions = cluster_regions(
                    mesh.coords[:, :2], self.num_regions_range, self.random
                )
                if cluster_pool is not None:
                    cluster_pool.append(regions)
            non_empty = [r for r in regions if len(r) > 0]
            mats = [
                self.random.choice(MATERIALS).as_tuple() for _ in non_empty
            ]
            if len(set(mats)) != len(non_empty):
                continue  # duplicate material draw collapses regions: resample
            if sum(len(r) for r in regions) != mesh.num_nodes:
                continue

            condition = {
                "material_regions": list(zip(mats, non_empty)),
                "point_constraints": sorted(vertices_to_constrain),
                "edge_constraints": list(edges_to_constrain),
                "point_forces": list(point_forces),
                "edge_forces": list(edge_forces),
            }

            key = self._condition_key(condition)
            if key not in {self._condition_key(c) for c in conditions}:
                conditions.append(condition)

        # Attach magnitudes.
        sign = [-1, 1]
        for condition in conditions:
            condition["point_forces"] = [
                (v, self._magnitude()) for v in condition["point_forces"]
            ]
            condition["edge_forces"] = [
                (e, self._magnitude()) for e in condition["edge_forces"]
            ]
        return conditions

    def sample_one(
        self,
        mesh,
        cluster_pool: Optional[List] = None,
        reuse_probability: float = 0.8,
    ) -> Dict:
        return self.sample(
            mesh,
            num_conditions=1,
            cluster_pool=cluster_pool,
            reuse_probability=reuse_probability,
        )[0]

    def _magnitude(self) -> Tuple[int, int]:
        r = self.random
        return (
            r.randint(*self.force_magnitude_range) * r.choice([-1, 1]),
            r.randint(*self.force_magnitude_range) * r.choice([-1, 1]),
        )

    @staticmethod
    def _condition_key(c: Dict):
        # Called before magnitudes are attached: forces are plain ids/edges.
        return (
            tuple(c["point_constraints"]),
            tuple(sorted(c["edge_constraints"])),
            tuple(sorted(c["point_forces"])),
            tuple(sorted(c["edge_forces"])),
            tuple(
                (m, tuple(np.asarray(r).tolist()))
                for m, r in c["material_regions"]
            ),
        )
