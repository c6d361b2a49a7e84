"""On-disk dataset writers — the reference's exact layout and txt formats
(the port's own copy of fea_tpu/datagen/writers.py).

Contract (README.md:46-79 of the reference; produced by its
generate.py:79-157 + fea_analysis.py:472-613):

  data/<plate>/outline.png, input.png
  data/<plate>/<condition>/
      magnitudes.txt       "VertexForce0:(fx, fy)" per force region
      materials.txt        "MaterialRegion0:(E, nu)" per region
      ranges.txt           "displacement_x_<step>:(lo, hi)" per step/type
      regions_{VertexForce,EdgeForce,VertexConstraint,EdgeConstraint,
               MaterialRegion}<i>.png
      outputs_displacement_{x,y}.png        (step-1 field only)
      [save_meshes] domain.<N>.vtk per step ("N" if num_steps<=10 else "0N")
"""

import os
from typing import Tuple

import numpy as np
from PIL import Image


def verify_directory(directory: str) -> None:
    os.makedirs(directory, exist_ok=True)


def clear_directory(directory: str) -> None:
    """Reference clear_condition_dir (fea_analysis.py:166-168)."""
    if not os.path.isdir(directory):
        return
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if os.path.isfile(path):
            os.remove(path)


def append_region_value(path: str, region_name: str, value: Tuple) -> None:
    """'Name:(a, b)' lines (fea_analysis.py:170-174)."""
    with open(path, "a+") as f:
        f.write("{}:{}\n".format(region_name, str(tuple(value))))


def save_gray_png(path: str, img: np.ndarray) -> None:
    """Write a grayscale uint8 PNG (mode L, fast compression).

    The reference's renderer wrote RGB; its dataset loader grayscales
    immediately (diffusion.py:121), so L-mode files are drop-in and 3x
    smaller/faster to encode."""
    arr = np.asarray(img, dtype=np.uint8)
    Image.fromarray(arr, mode="L").save(path, compress_level=1)


def domain_vtk_name(step: int, num_steps: int) -> str:
    """'domain.N.vtk' below 11 steps, zero-padded 'domain.0N.vtk' above
    (fea_analysis.py:473-476,586-589)."""
    if num_steps <= 10:
        return f"domain.{step}.vtk"
    return "domain.{:0>2}.vtk".format(step)


def find_image_bounds(image_path: str) -> Tuple[int, int, int, int]:
    """Bounding box of non-white pixels (reference utils.py:18-56 probe,
    kept for API parity; the pipeline frames analytically instead)."""
    arr = np.array(Image.open(image_path).convert("RGB"))
    nonwhite = (arr != 255).any(axis=-1)
    cols = np.where(nonwhite.any(axis=0))[0]
    rows = np.where(nonwhite.any(axis=1))[0]
    if len(cols) == 0:
        return 0, 0, arr.shape[1], arr.shape[0]
    return int(cols[0]), int(rows[0]), int(cols[-1]), int(rows[-1])
