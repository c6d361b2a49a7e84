"""Turn a checkpoint of fea_tpu's regression Trainer into one the port loads.

fea_tpu's `Trainer.save_checkpoint` writes its TrainState (params, the
three optax chains' states, EMA params, step, lowest sample loss) as an
orbax directory `model-<milestone>/`. This tool reads such a directory
and writes `state.pt` in the layout `fea_tpu_torch.train.Trainer`
saves and `load_checkpoint` reads: the params and EMA params through
`fea_tpu_torch.models.convert.from_flax`, Adam's count / mu / nu per
module in the order of the port module's parameters, step and lowest
sample loss as they are. It lives outside the package because reading the
directory needs orbax, and so JAX; the port imports neither.

    python tools/convert_orbax_checkpoint.py RESULTS/model-final OUT/model-final \\
        --image_size 256 --input_dim 64 --num_stages 4

then `TrainerConfig(results_folder="OUT", ...)` and
`Trainer.load_checkpoint("final")`. The model flags must be those the
checkpoint was trained with: a leaf or a shape without its counterpart in
the port raises and names it.
"""

import argparse
import sys
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fea_tpu_torch.models.convert import from_flax  # noqa: E402
from fea_tpu_torch.models.fdnunet import build_models  # noqa: E402
from fea_tpu_torch.train.trainer import MODULES  # noqa: E402


def read_orbax(path: Path) -> Mapping:
    """The checkpoint as orbax restores it without a template: nested
    dicts and lists of numpy arrays (an optax EmptyState comes back None)."""
    import orbax.checkpoint as ocp

    with ocp.PyTreeCheckpointer() as checkpointer:
        return checkpointer.restore(Path(path).absolute())


def adam_state(chain, where: str) -> Mapping:
    """The one ScaleByAdamState (count, mu, nu) in the restored state of
    optax.chain(clip_by_global_norm, adam); anything else in it that holds
    values has no counterpart in the port and raises."""
    found = []

    def walk(node, at):
        if node is None:  # EmptyState: clip's, and adam's scale-by-lr
            return
        if isinstance(node, Mapping) and set(node) == {"count", "mu", "nu"}:
            found.append(node)
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, f"{at}[{i}]")
        else:
            raise ValueError(f"{at}: optimizer state with no counterpart in the port: {node!r:.200}")

    walk(chain, where)
    if len(found) != 1:
        raise ValueError(f"{where}: expected one Adam state, found {len(found)}")
    return found[0]


def by_parameter(tree: Mapping, module: torch.nn.Module, where: str) -> dict:
    """from_flax(tree), checked against the port module: every parameter
    matched by one leaf of its shape, and no leaf left over."""
    state = from_flax(tree)
    shapes = {name: tuple(p.shape) for name, p in module.named_parameters()}
    missing = sorted(set(shapes) - set(state))
    extra = sorted(set(state) - set(shapes))
    if missing or extra:
        raise ValueError(f"{where}: no leaf for {missing}, no parameter for {extra}")
    for name, shape in shapes.items():
        if tuple(state[name].shape) != shape:
            raise ValueError(
                f"{where}.{name}: checkpoint has {tuple(state[name].shape)}, the port's "
                f"module {shape} (model flags differ from the trained model's?)"
            )
    return {name: state[name] for name in shapes}  # the module's order


def convert(raw: Mapping, modules: Mapping[str, torch.nn.Module]) -> dict:
    """The port's checkpoint dict from a restored fea_tpu TrainState."""
    unknown = set(raw) - {"params", "opt_states", "ema_params", "step", "lowest_sample_loss"}
    if unknown:
        raise ValueError(f"checkpoint fields with no counterpart in the port: {sorted(unknown)}")
    out = {"params": {}, "opt_states": {}, "ema_params": None}
    for key in MODULES:
        module = modules[key]
        out["params"][key] = by_parameter(raw["params"][key], module, f"params.{key}")
        adam = adam_state(raw["opt_states"][key], f"opt_states.{key}")
        out["opt_states"][key] = {
            "count": torch.tensor(int(np.asarray(adam["count"])), dtype=torch.int32),
            "mu": list(by_parameter(adam["mu"], module, f"opt_states.{key}.mu").values()),
            "nu": list(by_parameter(adam["nu"], module, f"opt_states.{key}.nu").values()),
        }
    if raw.get("ema_params") is not None:
        out["ema_params"] = {
            key: by_parameter(raw["ema_params"][key], modules[key], f"ema_params.{key}")
            for key in MODULES
        }
    out["step"] = int(np.asarray(raw["step"]))
    out["lowest_sample_loss"] = float(np.asarray(raw["lowest_sample_loss"]))
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("orbax_dir", type=Path, help="fea_tpu's model-<milestone> directory")
    parser.add_argument("out_dir", type=Path, help="directory to write state.pt into")
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--input_dim", type=int, default=64)
    parser.add_argument("--num_stages", type=int, default=4)
    parser.add_argument("--num_channels", type=int, default=2)
    parser.add_argument("--num_auxiliary_condition_channels", type=int, default=3)
    args = parser.parse_args(argv)

    modules = dict(zip(MODULES, build_models(
        input_dim=args.input_dim,
        image_height=args.image_size,
        image_width=args.image_size,
        num_stages=args.num_stages,
        num_channels=args.num_channels,
        num_auxiliary_condition_channels=args.num_auxiliary_condition_channels,
    )))
    state = convert(read_orbax(args.orbax_dir), modules)
    args.out_dir.mkdir(parents=True, exist_ok=True)
    torch.save(state, args.out_dir / "state.pt")
    n = sum(t.numel() for sd in state["params"].values() for t in sd.values())
    print(f"{args.out_dir / 'state.pt'}: step {state['step']}, {n} parameters, "
          f"EMA {'yes' if state['ema_params'] is not None else 'no'}")


if __name__ == "__main__":
    main()
