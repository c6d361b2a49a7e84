"""The PyTorch port imports with JAX and flax absent, and names neither."""

import pathlib
import re
import subprocess
import sys

PACKAGE = pathlib.Path(__file__).resolve().parent.parent / "fea_tpu_torch"
MODULES = [
    "fea_tpu_torch",
    "fea_tpu_torch.ops",
    "fea_tpu_torch.ops.flash_attention",
    "fea_tpu_torch.ops.fused_norm",
    "fea_tpu_torch.ops.cg",
    "fea_tpu_torch.ops.band",
    "fea_tpu_torch.ops.graphs",
    "fea_tpu_torch.ops._build",
    "fea_tpu_torch.models",
    "fea_tpu_torch.models.blocks",
    "fea_tpu_torch.models.attention",
    "fea_tpu_torch.models.time_embedding",
    "fea_tpu_torch.models.fdnunet",
    "fea_tpu_torch.models.diffusion",
    "fea_tpu_torch.models.adm",
    "fea_tpu_torch.models.convert",
    "fea_tpu_torch.models.initializers",
    "fea_tpu_torch.models.unet",
    "fea_tpu_torch.utils.device",
    "fea_tpu_torch.data",
    "fea_tpu_torch.data.dataset",
    "fea_tpu_torch.data.store",
    "fea_tpu_torch.data.device_store",
    "fea_tpu_torch.materials",
    "fea_tpu_torch.geometry",
    "fea_tpu_torch.geometry.polygon",
    "fea_tpu_torch.mesh",
    "fea_tpu_torch.mesh.mesher",
    "fea_tpu_torch.mesh.mesh_io",
    "fea_tpu_torch.fem",
    "fea_tpu_torch.fem.elasticity",
    "fea_tpu_torch.fem.assembly",
    "fea_tpu_torch.fem.solver",
    "fea_tpu_torch.fem.coarse",
    "fea_tpu_torch.fem.problem",
    "fea_tpu_torch.fem.direct",
    "fea_tpu_torch.fem.banded",
    "fea_tpu_torch.fem.flatgroup",
    "fea_tpu_torch.geometry.sampler",
    "fea_tpu_torch.raster",
    "fea_tpu_torch.raster.locate",
    "fea_tpu_torch.raster.rasterizer",
    "fea_tpu_torch.datagen",
    "fea_tpu_torch.datagen.regions",
    "fea_tpu_torch.datagen.conditions",
    "fea_tpu_torch.datagen.writers",
    "fea_tpu_torch.datagen.pipeline",
    "fea_tpu_torch.datagen.batched",
    "fea_tpu_torch.data.arrays",
    "fea_tpu_torch.utils.profiling",
    "fea_tpu_torch.train",
    "fea_tpu_torch.train.ema",
    "fea_tpu_torch.train.optim",
    "fea_tpu_torch.train.trainer",
    "fea_tpu_torch.train.diffusion_trainer",
    "fea_tpu_torch.utils.logs",
    "fea_tpu_torch.metrics",
    "fea_tpu_torch.metrics.accuracy",
    "fea_tpu_torch.metrics.stats",
    "fea_tpu_torch.apps",
    "fea_tpu_torch.apps.specs",
    "fea_tpu_torch.apps.runner",
    "fea_tpu_torch.cli",
    "fea_tpu_torch.__main__",
    "fea_tpu_torch.parallel",
    "fea_tpu_torch.parallel.distributed",
    "fea_tpu_torch.parallel.mesh",
    "fea_tpu_torch.parallel.launch",
    "fea_tpu_torch.parallel.scaling",
]
BLOCK = [
    "import sys",
    "sys.modules['jax'] = None",
    "sys.modules['flax'] = None",
    "sys.modules['fea_tpu'] = None",
]


def test_imports_without_jax_or_flax():
    code = "\n".join([
        *BLOCK,
        "import importlib",
        *(f"importlib.import_module({m!r})" for m in MODULES),
        "assert not any(m.startswith(('jax', 'flax', 'fea_tpu.')) or m == 'fea_tpu'"
        " for m in sys.modules if sys.modules[m] is not None)",
    ])
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=PACKAGE.parent,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_no_jax_import_in_source():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|fea_tpu)\b", re.M)
    offenders = [
        str(p) for p in PACKAGE.rglob("*.py") if pattern.search(p.read_text())
    ]
    assert offenders == []


def test_cli_help_without_jax():
    """`python -m fea_tpu_torch --help` with jax, flax and fea_tpu blocked
    exits 0 and lists the seven subcommands."""
    code = "\n".join([
        *BLOCK,
        "import runpy",
        "sys.argv = ['fea_tpu_torch', '--help']",
        "runpy.run_module('fea_tpu_torch', run_name='__main__', alter_sys=True)",
    ])
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=PACKAGE.parent,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    for command in ("generate", "train", "store", "train-diffusion", "sample", "accuracy", "app"):
        assert command in proc.stdout
    assert "--device" in proc.stdout
