"""The one seam between the port and its native code, `ops/_build.py`, on
the CPU: `bind` on the host library the mesher uses (the CDT library, built
with g++), the launch checks every CUDA wrapper shares, and the kernel
layer's imports (no module of `fea_tpu_torch/ops/` reaches up into another
package of the port, or into a sibling's private names). Imports no JAX.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from fea_tpu_torch.mesh import mesher
from fea_tpu_torch.ops import _build

OPS = pathlib.Path(__file__).resolve().parent.parent / "fea_tpu_torch" / "ops"
SYMBOLS = ("fea_triangulate", "fea_hinge_singular")


def test_bind_opens_the_mesher_library_once_and_the_mesher_goes_through_it(monkeypatch):
    table = {symbol: mesher.LIBRARY.signatures[symbol] for symbol in SYMBOLS}
    library = _build.bind("fea_cdt", ["cdt.cpp"], table, host=True)
    assert library is mesher.LIBRARY
    assert library is _build.bind("fea_cdt", ["cdt.cpp"], table, host=True)
    assert set(library.signatures) == set(SYMBOLS)  # a host library: no CUDA error text
    assert library.lib is library.lib
    for symbol, (argtypes, restype) in table.items():
        assert list(getattr(library.lib, symbol).argtypes) == list(argtypes)
        assert getattr(library.lib, symbol).restype is restype

    read, lib = [], library.lib

    class Recorder:
        def __getattr__(self, symbol):
            read.append(symbol)
            return getattr(lib, symbol)

    monkeypatch.setitem(library.__dict__, "lib", Recorder())
    mesh = mesher.triangulate(np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]),
                              mesh_size=0.25)
    assert mesh.num_triangles > 0
    assert mesher.hinge_singular(mesh.triangles, np.ones(mesh.num_nodes, bool)) is False
    assert read == list(SYMBOLS)


def test_the_launch_checks_raise_what_the_wrappers_raised():
    """The shared checks refuse, with the wrappers' exception types, what
    the kernels do not take; each message names the kernel."""
    cuda = torch.device("cuda", 0)  # a device object: nothing touches a card
    dtypes = (torch.float32, torch.float64)
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="k takes CUDA tensors"):
        _build.check_tensors("k", x.device, x.dtype, dtypes, {"x": (x, None, (8,))})
    with pytest.raises(TypeError, match="k takes float32 or float64"):
        _build.check_tensors("k", cuda, torch.bfloat16, dtypes, {})
    with pytest.raises(ValueError, match="x: k takes a contiguous"):
        _build.check_tensors("k", cuda, torch.float32, dtypes, {"x": (x, None, (8,))})
    _build.check_tensors("k", cuda, torch.float32, dtypes, {"x": (None, None, (8,))})
    with pytest.raises(ValueError, match="k takes q, v on one CUDA device"):
        _build.check_device("k", {"q": x, "v": x})
    square = torch.zeros((4, 4))
    _build.check_contiguous("k", {"x": square})
    with pytest.raises(ValueError, match="x: k takes a contiguous"):
        _build.check_contiguous("k", {"x": square.T})
    _build.check_aligned("k", {"x": x, "none": None})
    with pytest.raises(ValueError, match="x: k takes tensors that start on a 16-byte"):
        _build.check_aligned("k", {"x": x[1:]})


def test_the_kernel_layer_imports_no_other_package_of_the_port():
    """Every module of `fea_tpu_torch/ops/` imports only its siblings (and
    no sibling's underscore-prefixed names) and packages outside the port."""
    offenders = []
    for path in sorted(OPS.glob("*.py")):
        tree = ast.parse(path.read_text())
        siblings = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                offenders += [f"{path.name}: import {a.name}" for a in node.names
                              if a.name.startswith("fea_tpu_torch")
                              and not a.name.startswith("fea_tpu_torch.ops")]
            elif isinstance(node, ast.ImportFrom):
                module = node.module or ""
                inside = node.level == 1 or module.startswith("fea_tpu_torch.ops")
                if not inside and (node.level > 0 or module.split(".")[0] == "fea_tpu_torch"):
                    offenders.append(f"{path.name}: from {'.' * node.level}{module}")
                if inside and not module:  # from . import graphs
                    siblings |= {a.asname or a.name for a in node.names}
                offenders += [f"{path.name}: from {'.' * node.level}{module} import {a.name}"
                              for a in node.names if inside and a.name.startswith("_")
                              and not (module == "" and a.name == "_build")]
        offenders += [f"{path.name}: {node.value.id}.{node.attr}" for node in ast.walk(tree)
                      if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                      and node.value.id in siblings and node.attr.startswith("_")]
    assert offenders == []
