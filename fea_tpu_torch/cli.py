"""Command-line entry points: `python -m fea_tpu_torch [--device D] <command>`.

The port of fea_tpu/cli.py: the same seven subcommands (generate, train,
store, train-diffusion, sample, accuracy, app) with the same options,
defaults and choices, mapped onto the port's functions as fea_tpu maps
them onto its own. `main` joins the process group first when the
environment names one (parallel/distributed.py; under torchrun: `torchrun
--nproc_per_node N -m fea_tpu_torch train ...`), and `train` and
`train-diffusion` then train data-parallel over it; `generate --batched
--num_devices N` shards datagen's chunks over N devices in one process.
It differs from fea_tpu's CLI in these ways:
  * there is no compilation cache to enable (fea_tpu's
    `_enable_compilation_cache()`): the port compiles nothing ahead; its
    CUDA kernels build at first use into fea_tpu_torch/_build;
  * the platform is the global `--device` option, given before the
    subcommand, instead of fea_tpu's FEA_TPU_PLATFORM environment variable:
    the CUDA device by default (the CLI raises where there is none), under
    a process group the rank's own, `cpu` on request (a CPU group runs on
    gloo); the arguments are parsed before the group is joined, since
    `--device` picks the group's device;
  * `generate --num_devices` above 1 without `--batched` raises, where
    fea_tpu ignores it: the sequential path runs on one device.
The commands that run the model (train, train-diffusion, sample, and app
with a checkpoint) print one line naming the precision of the model's f32
convolutions (utils/precision.py), which their entry points run under.
"""

import argparse
import json
import os

import torch

from .parallel.distributed import ensure_initialized, local_device, shutdown
from .utils.device import resolve_device
from .utils.precision import conv_precision


def _log_precision(command):
    print(f"{command}: the model's f32 convolutions run at {conv_precision()} "
          "(fea_tpu_torch/utils/precision.py)", flush=True)


def _add_generate(sub):
    p = sub.add_parser("generate", help="Generate the FEA dataset.")
    p.add_argument("--num_plates", type=int, default=1)
    p.add_argument("--start_plate", type=int, default=None)
    p.add_argument("--conditions_per_plate", type=int, default=4)
    p.add_argument("--steps_per_condition", type=int, default=11)
    p.add_argument("--mesh_size", type=float, default=1e-2)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--save_meshes", action="store_true")
    p.add_argument("--save_displacement", action="store_true")
    p.add_argument("--save_strain", action="store_true")
    p.add_argument("--save_stress", action="store_true")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--batched", action="store_true",
                   help="multi-plate batched solve path (plate groups solved "
                        "as one flat chunk on the device)")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_devices", type=int, default=None,
                   help="with --batched: shard each chunk's plates over this "
                        "many devices, one solve worker each (cuda:0 .. "
                        "cuda:N-1, or N shards on the CPU with --device cpu)")
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--wandb_project", type=str, default=None)
    return p


def _cmd_generate(args, device):
    if not (args.save_displacement or args.save_strain or args.save_stress):
        raise ValueError("Must save at least one of displacement, strain, or stress.")
    if args.num_devices not in (None, 1) and not args.batched:
        raise ValueError(
            f"--num_devices {args.num_devices} shards the --batched path; the "
            "sequential path runs on one device"
        )

    wandb_fn = None
    if args.use_wandb:
        import wandb

        if args.wandb_project is None:
            raise ValueError("Must specify wandb project name.")
        wandb.init(project=args.wandb_project)

        def wandb_fn(plate_index, total_time, remaining):
            wandb.log(
                {
                    "plate_index": plate_index,
                    "total_time": total_time,
                    "remaining": remaining,
                }
            )

    common = dict(
        data_dir=args.data_dir,
        image_size=args.image_size,
        num_plates=args.num_plates,
        start_plate=args.start_plate,
        conditions_per_plate=args.conditions_per_plate,
        mesh_size=args.mesh_size,
        save_displacement=args.save_displacement,
        save_strain=args.save_strain,
        save_stress=args.save_stress,
        num_steps_per_condition=args.steps_per_condition,
        save_meshes=args.save_meshes,
        seed=args.seed,
        wandb_inject_function=wandb_fn,
        device=device,
    )
    if args.batched:
        from .datagen.batched import generate_data_batched

        stats = generate_data_batched(
            batch_size=args.batch_size, n_devices=args.num_devices, **common
        )
        # one-line solver telemetry so production logs record the
        # failure/rejection rates
        print(
            "solver stats: "
            + json.dumps({
                k: stats.get(k)
                for k in (
                    "plates", "solves", "cg_failures", "direct_fallbacks",
                    "cg_resamples", "continuations", "host_rejections",
                    "lane_dispatches",
                )
            })
        )
        return

    from .datagen import generate_data

    generate_data(**common)


def _add_train(sub):
    p = sub.add_parser("train", help="Train the FDN-UNet surrogate.")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--sample_data_dir", type=str, default="sample_data")
    p.add_argument("--num_steps_per_condition", type=int, default=6)
    p.add_argument("--num_steps_per_sample_condition", type=int, default=6)
    p.add_argument("--conditions_per_plate", type=int, default=4)
    p.add_argument("--num_sample_conditions_per_plate", type=int, default=1)
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--skip_dataset_size_check", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--cache_dataset", action="store_true", default=None,
                   help="Keep decoded samples in RAM (~2 MB each at "
                        "256px). Default: auto (on when the decoded set "
                        "takes under a quarter of the free RAM).")
    p.add_argument("--dataset_store", type=str, default=None,
                   help="decoded-on-disk condition store built with "
                        "`fea_tpu_torch store`; feeds production-scale "
                        "datasets at device speed (overrides --data_dir for "
                        "the train set)")
    p.add_argument("--device_resident_store", action="store_true",
                   help="with --dataset_store: upload the condition "
                        "tables to the device once and assemble batches "
                        "there from index vectors; bit-exact, falls back "
                        "to the host feed when the tables exceed the cap "
                        "(the device's memory less the train step's reserve)")
    p.add_argument("--no_cache_dataset", dest="cache_dataset",
                   action="store_false", help=argparse.SUPPRESS)
    p.add_argument("--num_gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--num_steps", type=int, default=10000)
    p.add_argument("--num_steps_per_milestone", type=int, default=500)
    p.add_argument("--learning_rate", type=float, default=3e-4)
    p.add_argument("--loss_type", type=str, default="l1", choices=["l1", "l2"])
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--disable_auxiliary", action="store_true", default=None)
    p.add_argument("--only_auxiliary", action="store_true")
    p.add_argument("--use_ema_model", action="store_true")
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=["bfloat16", "float32"],
                   help="bfloat16 = mixed precision: bf16 compute, "
                        "f32 master weights (no loss scaling needed)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the forward pass during backward "
                        "(~1/3 more FLOPs, near-zero stored activations) "
                        "— use when --device_resident_store tables + "
                        "activations crowd the device's memory")
    p.add_argument("--no_progress_bar", action="store_true")
    p.add_argument("--input_dim", type=int, default=64,
                   help="base channel width of the FDN-UNet (the "
                        "reference hardcodes 64, train_model.py:44); "
                        "smaller widths give cheap smoke runs")
    p.add_argument("--num_stages", type=int, default=4,
                   help="UNet depth (dim_mults length)")
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--wandb_project", type=str, default=None)
    p.add_argument("--wandb_restrict_cache", type=int, default=10,
                   help="GB cap passed to `wandb artifact cache cleanup` "
                        "before each checkpoint upload")
    return p


def _cmd_train(args, device):
    from .train.trainer import Trainer, TrainerConfig

    config = TrainerConfig(
        dataset_folder=args.data_dir,
        sample_dataset_folder=args.sample_data_dir,
        dataset_image_size=args.image_size,
        train_batch_size=args.batch_size,
        num_gradient_accumulation_steps=args.num_gradient_accumulation_steps,
        num_train_steps=args.num_steps,
        num_steps_per_milestone=args.num_steps_per_milestone,
        train_learning_rate=args.learning_rate,
        loss_type=args.loss_type,
        num_steps_per_condition=args.num_steps_per_condition,
        num_steps_per_sample_condition=args.num_steps_per_sample_condition,
        conditions_per_plate=args.conditions_per_plate,
        num_sample_conditions_per_plate=args.num_sample_conditions_per_plate,
        results_folder=args.results_dir,
        skip_dataset_size_check=args.skip_dataset_size_check,
        cache_datasets=args.cache_dataset,
        dataset_store=args.dataset_store,
        device_resident_store=args.device_resident_store,
        remat_loss=args.remat,
        disable_auxiliary=(
            True if args.disable_auxiliary is None else args.disable_auxiliary
        ),
        only_auxiliary=args.only_auxiliary,
        use_ema=args.use_ema_model,
        compute_dtype=(
            None if args.compute_dtype in (None, "float32")
            else args.compute_dtype
        ),
        progress_bar=not args.no_progress_bar,
        input_dim=args.input_dim,
        num_stages=args.num_stages,
    )
    _log_precision("train")
    trainer = Trainer(config, device=device)
    if args.checkpoint is not None:
        trainer.load_checkpoint(args.checkpoint)

    wandb_fn = None
    if args.use_wandb and trainer.is_main:
        import wandb

        if args.wandb_project is None:
            raise ValueError("Must specify wandb project name.")
        wandb.init(project=args.wandb_project)
        wandb.define_metric("step")
        wandb.define_metric("train_loss", step_metric="step")
        wandb.define_metric("sample_loss", step_metric="step")

        def wandb_fn(step, loss, sample_loss, image_filenames, ranges, milestone):
            log = {"step": step, "train_loss": loss}
            if sample_loss is not None:
                log["sample_loss"] = sample_loss
            if image_filenames:
                log["samples"] = [wandb.Image(f) for f in image_filenames]
            if ranges is not None:
                log["ranges"] = ranges
            wandb.log(log)
            # checkpoint-zip artifact upload + cache cleanup (reference
            # train_model.py:108-114; the Trainer already writes the zips)
            if milestone is not None:
                if args.wandb_restrict_cache is not None:
                    os.system(
                        "wandb artifact cache cleanup "
                        f"{args.wandb_restrict_cache}GB"
                    )
                artifact = wandb.Artifact(
                    name=f"checkpoint-{wandb.run.id}", type="model"
                )
                if milestone == "latest":
                    prev = os.path.join(args.results_dir, "model-latest-prev.zip")
                    if os.path.exists(prev):
                        artifact.add_file(prev)
                artifact.add_file(
                    os.path.join(args.results_dir, f"model-{milestone}.zip")
                )
                wandb.log_artifact(artifact)

    trainer.train(wandb_inject_function=wandb_fn)


def _add_store(sub):
    p = sub.add_parser(
        "store",
        help="Build the decoded-on-disk condition store for a generated "
             "dataset (resumable; can trail a running datagen via "
             "--follow_pid).",
    )
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--store_dir", type=str, required=True)
    p.add_argument("--num_plates", type=int, required=True)
    p.add_argument("--image_size", type=int, default=256,
                   help="training-time image size (the store holds "
                        "pre-resized grids)")
    p.add_argument("--conditions_per_plate", type=int, default=4)
    p.add_argument("--steps_per_condition", type=int, default=6)
    p.add_argument("--follow_pid", type=int, default=None)


def _cmd_store(args, device):
    from .data.store import build_condition_store

    build_condition_store(
        args.data_dir,
        args.store_dir,
        num_plates=args.num_plates,
        image_size=args.image_size,
        conditions_per_plate=args.conditions_per_plate,
        num_steps=args.steps_per_condition,
        follow_pid=args.follow_pid,
        verbose=True,
    )


def _add_train_diffusion(sub):
    p = sub.add_parser(
        "train-diffusion",
        help="Train the conditional-diffusion (DDPM) FDN-UNet mode.",
    )
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_steps", type=int, default=10000)
    p.add_argument("--num_steps_per_milestone", type=int, default=500)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--objective", type=str, default="pred_noise",
                   choices=["pred_noise", "pred_x0"])
    p.add_argument("--conditions_per_plate", type=int, default=4)
    p.add_argument("--num_steps_per_condition", type=int, default=6)
    p.add_argument("--results_dir", type=str, default="results_diffusion")
    p.add_argument("--skip_dataset_size_check", action="store_true",
                   help=argparse.SUPPRESS)
    return p


def _cmd_train_diffusion(args, device):
    from .train.diffusion_trainer import DiffusionConfig, DiffusionTrainer

    config = DiffusionConfig(
        dataset_folder=args.data_dir,
        dataset_image_size=args.image_size,
        conditions_per_plate=args.conditions_per_plate,
        num_steps_per_condition=args.num_steps_per_condition,
        train_batch_size=args.batch_size,
        train_learning_rate=args.learning_rate,
        num_train_steps=args.num_steps,
        num_steps_per_milestone=args.num_steps_per_milestone,
        timesteps=args.timesteps,
        objective=args.objective,
        results_folder=args.results_dir,
        skip_dataset_size_check=args.skip_dataset_size_check,
    )
    _log_precision("train-diffusion")
    DiffusionTrainer(config, device=device).train()


def _add_sample(sub):
    p = sub.add_parser("sample", help="Sample a trained model over a dataset.")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--sample_data_dir", type=str, default="sample_data")
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--milestone", type=str, required=True)
    p.add_argument("--num_steps_per_condition", type=int, default=6)
    p.add_argument("--num_sample_conditions_per_plate", type=int, default=1)
    p.add_argument("--use_ema", action="store_true",
                   help="Sample with the EMA weights from the checkpoint "
                        "(reference generateapplication.ipynb cell 16 loads "
                        "checkpoints into an ema_pytorch.EMA wrapper)")
    p.add_argument("--input_dim", type=int, default=64,
                   help="must match the width the checkpoint was trained "
                        "with (see `train --input_dim`)")
    p.add_argument("--num_stages", type=int, default=4)
    return p


def _cmd_sample(args, device):
    from .train.trainer import Trainer, TrainerConfig

    config = TrainerConfig(
        dataset_folder=args.data_dir,
        sample_dataset_folder=args.sample_data_dir,
        dataset_image_size=args.image_size,
        train_batch_size=args.batch_size,
        num_steps_per_condition=args.num_steps_per_condition,
        num_steps_per_sample_condition=args.num_steps_per_condition,
        num_sample_conditions_per_plate=args.num_sample_conditions_per_plate,
        results_folder=args.results_dir,
        skip_dataset_size_check=True,
        inference_only=True,
        use_ema=args.use_ema,
        input_dim=args.input_dim,
        num_stages=args.num_stages,
    )
    _log_precision("sample")
    trainer = Trainer(config, device=device)
    trainer.load_checkpoint(args.milestone)
    trainer.sample_and_save(
        milestone=args.milestone, progress_bar=True, use_ema=args.use_ema
    )


def _add_accuracy(sub):
    p = sub.add_parser("accuracy", help="Displacement accuracy vs ground truth.")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--milestone", type=str, default=None)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--num_plates", type=int, default=1)
    p.add_argument("--conditions_per_plate", type=int, default=4)
    p.add_argument("--steps_per_condition", type=int, default=6)
    p.add_argument("--per_step", action="store_true")
    p.add_argument("--progress", action="store_true",
                   help="tqdm over samples (300+ slow VTK/PNG reads at "
                        "production eval sizes)")
    return p


def _cmd_accuracy(args, device):
    from .metrics.accuracy import calculate_accuracy, calculate_accuracy_per_step

    fn = calculate_accuracy_per_step if args.per_step else calculate_accuracy
    out = fn(
        data_dir=args.data_dir,
        results_dir=args.results_dir,
        milestone=args.milestone,
        image_size=args.image_size,
        num_plates=args.num_plates,
        conditions_per_plate=args.conditions_per_plate,
        steps_per_condition=args.steps_per_condition,
        progress=args.progress,
    )
    print(out)
    return out


def _add_app(sub):
    p = sub.add_parser("app", help="Run an application problem end to end.")
    p.add_argument(
        "name",
        choices=[
            "cantilever", "gusset", "shearblade", "composite",
            "composite_coupled",
        ],
    )
    p.add_argument("--output_dir", type=str, default="app_output")
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Trained checkpoint (a model-<milestone> directory "
                        "holding state.pt) for surrogate prediction + metrics")
    p.add_argument("--use_ema", action="store_true",
                   help="Predict with the checkpoint's EMA weights")
    return p


def _cmd_app(args, device):
    from .apps.runner import run_application

    if args.checkpoint is not None:
        _log_precision("app")
    out = run_application(
        args.name,
        output_dir=args.output_dir,
        image_size=args.image_size,
        checkpoint=args.checkpoint,
        use_ema=args.use_ema,
        device=device,
    )
    print(out)
    return out


COMMANDS = {
    "generate": (_add_generate, _cmd_generate),
    "train": (_add_train, _cmd_train),
    "store": (_add_store, _cmd_store),
    "train-diffusion": (_add_train_diffusion, _cmd_train_diffusion),
    "sample": (_add_sample, _cmd_sample),
    "accuracy": (_add_accuracy, _cmd_accuracy),
    "app": (_add_app, _cmd_app),
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="fea_tpu_torch",
        description="FEA + surrogate framework on CUDA devices "
                    "(the PyTorch port of fea_tpu).",
    )
    parser.add_argument(
        "--device", type=str, default=None,
        help="torch device to run on (default: the CUDA device, under a "
             "process group the rank's own; raises where there is none); "
             "`cpu` runs everything on the host",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    for add, _ in COMMANDS.values():
        add(sub)
    return parser


def main(argv=None):
    """Parse `argv`, join the process group the environment names (if
    any), and run the command on `--device`; returns what the command
    returns (the accuracy and app results, else None)."""
    args = build_parser().parse_args(argv)
    owned = not torch.distributed.is_initialized()  # a caller's group stays
    grouped = ensure_initialized(device=args.device)
    try:
        # under a group, the rank's own device (`--device cuda` included)
        device = local_device() if grouped else resolve_device(args.device)
        return COMMANDS[args.command][1](args, device)
    finally:
        if grouped and owned:
            shutdown()


if __name__ == "__main__":
    main()
