"""The port's model precision policy (fea_tpu_torch/utils/precision.py).

On the CPU, at 32 px, input_dim 8 and 2 stages: every model entry point
runs its convolutions, forward and backward, at the policy's precision
("tf32" by default, "ieee" under an outer `model_precision(conv="ieee")`),
hands the caller's cuDNN flag back as it found it (also when the call
raises) and leaves `torch.backends.cuda.matmul` alone. The CPU's
convolutions do not read cuDNN's flag: global module hooks read, at each
convolution and at the gradient of its output, the flag that the card's
cuDNN would read there. The CLI commands that run the model print the
precision on one line, and a FEM solve after a surrogate prediction still
finds matmuls in strict f32 (`fem/problem.py` `_require_true_f32`).

The `gpu` test holds the TF32 forward of the full-width FDNUNet (the
sampler's model at 256 px, batch 2) and of the regression `predict`
(batch 4) to the strict f32 forward on the card. The bound of each is the
difference from the strict forward of a bf16 setting that a package
ships: for the predictor, the Trainer's `compute_dtype="bfloat16"` cast of
the weights and image inputs, the coarsest; for the FDNUNet, which has no
cast route in either package (its f32 time embedding meets bf16 weights,
and under torch.autocast its memory keys stay f32 beside bf16 queries),
its convolutions in one bf16 pass (operands rounded to bf16, sums in f32),
what XLA's default precision runs on fea_tpu's TPU. The TF32 forward must
also differ from the strict one, or the flag did not reach cuDNN. So the
tolerance is the bf16 setting's difference, measured in the same run: on
an NVIDIA H100 80GB HBM3 at 700.00 W it read 1.775e-02 (FDNUNet) and
3.160e-02 (predict), and TF32's differences 1.796e-03 and 2.678e-03,
9.9x and 11.8x inside it. It imports no JAX, so it runs on the card with
`python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_precision.py`.
"""

import copy
import functools

import numpy as np
import pytest
import torch

from fea_tpu_torch import cli
from fea_tpu_torch.apps import runner
from fea_tpu_torch.models import create_models, make_diffusion_model, predict
from fea_tpu_torch.train import diffusion_trainer, trainer
from fea_tpu_torch.utils import precision
from fea_tpu_torch.utils.precision import DEFAULT_CONV, conv_precision, model_precision

torch.set_num_threads(1)

S, DIM, STAGES, BATCH, ACCUM, T = 32, 8, 2, 2, 8, 4  # the Trainer's floor: 16 a step
MODEL_SIZE = 256  # predict_with_surrogate's model size
CALLER = "ieee"  # the flag the caller holds before each call: not the default


class Dataset:
    """Seeded samples in the FEADataset contract, made in memory."""

    conditions_per_plate_geometry = 1

    def __init__(self, n, size, seed):
        rng = np.random.default_rng(seed)
        self.num_steps = n
        self.samples = []
        for i in range(n):
            geometry = np.where(rng.random((size, size, 1)) < 0.7, 1.0, -1.0)
            ranges = rng.normal(size=4).astype(np.float32)

            def field(c):
                return (rng.normal(size=(size, size, c)) * (geometry + 1) / 2).astype(np.float32)

            self.samples.append({
                "plate_index": np.int32(1), "condition_index": np.int32(1),
                "iteration_index": np.int32(i + 1),
                "geometry": geometry.astype(np.float32),
                "displacement": np.tanh(field(2)), "forces": field(2), "materials": field(2),
                "constraints": np.where(rng.random((size, size, 1)) < 0.05, 1.0, -1.0).astype(
                    np.float32),
                "displacement_range": ranges,
                "log_displacement_range": np.log1p(np.abs(ranges)),
                "sign_displacement_range": (ranges >= 0).astype(np.float32),
            })

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        return self.samples[index]


def narrow_config():
    return functools.partial(trainer.TrainerConfig, input_dim=DIM, num_stages=STAGES)


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    """The objects whose entry points run: a diffusion model, the regression
    trio, a Trainer and a DiffusionTrainer on seeded in-memory data, and a
    checkpoint of narrow encoder and decoder weights at the runner's model
    size."""
    root = tmp_path_factory.mktemp("precision")
    g = torch.Generator().manual_seed(0)
    diffusion = make_diffusion_model(image_size=S, input_dim=DIM, num_stages=STAGES,
                                     timesteps=T, device="cpu", generator=g)
    encoder, decoder, _ = create_models(input_dim=DIM, image_height=S, image_width=S,
                                        num_channels=2, num_auxiliary_condition_channels=3,
                                        num_stages=STAGES, device="cpu", generator=g)
    data = Dataset(BATCH * ACCUM, S, 1)
    tr = trainer.Trainer(trainer.TrainerConfig(
        dataset_image_size=S, train_batch_size=BATCH, num_gradient_accumulation_steps=ACCUM,
        input_dim=DIM, num_stages=STAGES, disable_auxiliary=False, use_ema=True,
        skip_dataset_size_check=True, progress_bar=False,
        results_folder=str(root / "regression"), seed=0,
    ), dataset=data, sample_dataset=data, device="cpu")
    dt = diffusion_trainer.DiffusionTrainer(diffusion_trainer.DiffusionConfig(
        dataset_image_size=S, train_batch_size=BATCH, timesteps=T, input_dim=DIM,
        num_stages=STAGES, skip_dataset_size_check=True, results_folder=str(root / "diffusion"),
    ), dataset=data, device="cpu")

    cfg = narrow_config()()
    enc, dec, _ = create_models(
        input_dim=cfg.input_dim, image_height=MODEL_SIZE, image_width=MODEL_SIZE,
        num_channels=cfg.num_channels,
        num_auxiliary_condition_channels=cfg.num_auxiliary_condition_channels,
        num_stages=cfg.num_stages, device="cpu", generator=g)
    checkpoint = root / "model-final"
    checkpoint.mkdir()
    torch.save({"params": {"encoder": enc.state_dict(), "decoder": dec.state_dict()},
                "ema_params": None}, checkpoint / "state.pt")

    rng = np.random.default_rng(2)
    condition = torch.from_numpy(rng.normal(size=(BATCH, S, S, 5)).astype(np.float32))
    inputs = [torch.from_numpy(rng.normal(size=(BATCH, S, S, c)).astype(np.float32))
              for c in (2, 3)]
    geometry = torch.where(torch.from_numpy(rng.random((BATCH, S, S, 1))) < 0.7, 1.0, -1.0)
    x0, cond = dt._fetch(0)
    return dict(root=root, diffusion=diffusion, modules=(encoder, decoder), trainer=tr,
                diffusion_trainer=dt, checkpoint=checkpoint, condition=condition,
                inputs=(*inputs, geometry), fetched=(x0, cond))


def surrogate(s, monkeypatch, tag):
    """run_application with the checkpoint: the FEM solve, then the
    surrogate's prediction (predict_with_surrogate builds the model at
    TrainerConfig's defaults, made narrow here)."""
    monkeypatch.setattr(trainer, "TrainerConfig", narrow_config())
    return runner.run_application("gusset", output_dir=str(s["root"] / tag), image_size=64,
                                  checkpoint=str(s["checkpoint"]), device="cpu")


ENTRY_POINTS = {
    "GaussianDiffusion.sample": (False, lambda s, mp, tag: s["diffusion"].sample(
        s["condition"], 2, generator=torch.Generator().manual_seed(3))),
    "predict": (False, lambda s, mp, tag: predict(*s["modules"], *s["inputs"])),
    "Trainer._train_step": (True, lambda s, mp, tag: s["trainer"]._train_step(
        s["trainer"]._fetch_batch(0))),
    "Trainer.sample_and_save": (False, lambda s, mp, tag: s["trainer"].sample_and_save(
        save=False)),
    "DiffusionTrainer._train_step": (True, lambda s, mp, tag: s["diffusion_trainer"]._train_step(
        *s["fetched"])),
    "DiffusionTrainer.sample": (False, lambda s, mp, tag: s["diffusion_trainer"].sample(
        s["condition"], 2)),
    "predict_with_surrogate": (False, surrogate),
}


class Stop(Exception):
    """Raised by the recorder at the first convolution, to stop a call."""


def matmul_flags():
    m = torch.backends.cuda.matmul
    return m.allow_tf32, m.fp32_precision


@pytest.fixture
def recorder():
    """Global module hooks that record (direction, cuDNN's f32 convolution
    precision, the matmul flags) at every nn.Conv2d's forward and at the
    gradient of its output, just before its backward runs. `stop` makes the
    first forward raise. The flags are put back after the test."""
    saved = torch.backends.cudnn.conv.fp32_precision, matmul_flags()
    seen, state = [], {"stop": False}

    def record(direction):
        seen.append((direction, torch.backends.cudnn.conv.fp32_precision, matmul_flags()))

    def pre(module, args):
        if isinstance(module, torch.nn.Conv2d):
            record("forward")
            if state["stop"]:
                raise Stop()

    def post(module, args, out):
        if isinstance(module, torch.nn.Conv2d) and out.requires_grad:
            out.register_hook(lambda grad: record("backward"))

    hooks = [torch.nn.modules.module.register_module_forward_pre_hook(pre),
             torch.nn.modules.module.register_module_forward_hook(post)]
    try:
        yield seen, state
    finally:
        for h in hooks:
            h.remove()
        torch.backends.cudnn.conv.fp32_precision = saved[0]


@pytest.mark.parametrize("outer", [None, "ieee", "tf32"])
@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_runs_at_the_policy(setups, recorder, monkeypatch, name, outer):
    """Every convolution of the call, forward and (in a train step)
    backward, at the default or at the outer scope's explicit choice; the
    caller's flag and the matmul flags as they were, during and after."""
    seen, _ = recorder
    backward, call = ENTRY_POINTS[name]
    torch.backends.cudnn.conv.fp32_precision = CALLER
    matmul = matmul_flags()
    if outer is None:
        call(setups, monkeypatch, f"{name}-default")
    else:
        with model_precision(conv=outer):
            call(setups, monkeypatch, f"{name}-{outer}")
    want = outer or DEFAULT_CONV
    directions = {d for d, _, _ in seen}
    assert directions == ({"forward", "backward"} if backward else {"forward"})
    assert {p for _, p, _ in seen} == {want}
    assert {m for _, _, m in seen} == {matmul}
    assert torch.backends.cudnn.conv.fp32_precision == CALLER
    assert matmul_flags() == matmul
    assert conv_precision() == DEFAULT_CONV


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_restores_the_flag_when_it_raises(setups, recorder, monkeypatch, name):
    seen, state = recorder
    _, call = ENTRY_POINTS[name]
    torch.backends.cudnn.conv.fp32_precision = CALLER
    matmul = matmul_flags()
    state["stop"] = True
    with pytest.raises(Stop):
        call(setups, monkeypatch, f"{name}-raises")
    assert [p for _, p, _ in seen] == [DEFAULT_CONV]
    assert torch.backends.cudnn.conv.fp32_precision == CALLER
    assert matmul_flags() == matmul
    assert conv_precision() == DEFAULT_CONV


def test_fem_solve_after_the_surrogate_keeps_strict_matmuls(setups, monkeypatch):
    """The app with a checkpoint (a FEM solve, then the surrogate), then a
    FEM solve alone, in one process: the FEM's guard against TF32 matmuls
    passes in both, and the matmul flags never move."""
    matmul = matmul_flags()
    out = surrogate(setups, monkeypatch, "fem-before")
    assert np.isfinite(out["pred_mae"]) and matmul_flags() == matmul
    again = runner.run_application("gusset", output_dir=str(setups["root"] / "fem-after"),
                                   image_size=64, device="cpu")
    assert again["converged"] and "pred_mae" not in again
    assert matmul_flags() == matmul


def test_nested_scopes():
    """None keeps the enclosing choice; an explicit inner choice wins for
    its own block; each exit hands back the flag it found, also through an
    exception."""
    saved = torch.backends.cudnn.conv.fp32_precision
    flag = lambda: torch.backends.cudnn.conv.fp32_precision  # noqa: E731
    try:
        torch.backends.cudnn.conv.fp32_precision = "ieee"
        with model_precision() as chosen:
            assert chosen == flag() == conv_precision() == DEFAULT_CONV
        assert flag() == "ieee"
        with model_precision(conv="ieee"):
            with model_precision() as chosen:
                assert chosen == flag() == "ieee"
            with model_precision(conv="tf32"):
                assert flag() == conv_precision() == "tf32"
            assert flag() == conv_precision() == "ieee"
            with pytest.raises(KeyError), model_precision(conv="tf32"):
                raise KeyError()
            assert flag() == conv_precision() == "ieee"
        assert flag() == "ieee" and conv_precision() == DEFAULT_CONV
    finally:
        torch.backends.cudnn.conv.fp32_precision = saved


@pytest.mark.parametrize("name", ["bf16", "TF32", "highest", ""])
def test_unknown_precision_raises(name):
    before = torch.backends.cudnn.conv.fp32_precision
    with pytest.raises(ValueError, match="conv precision"), model_precision(conv=name):
        pass
    assert torch.backends.cudnn.conv.fp32_precision == before
    assert conv_precision() == DEFAULT_CONV


def test_policy_sets_the_one_flag_it_owns():
    """The default lives in the module; `model_precision` writes cuDNN's
    f32 convolution precision and nothing else of torch.backends."""
    assert precision.DEFAULT_CONV == "tf32" and precision.CONV_PRECISIONS == ("ieee", "tf32")
    backends = torch.backends
    before = (backends.cudnn.rnn.fp32_precision, backends.cudnn.fp32_precision,
              backends.fp32_precision, matmul_flags(), backends.cudnn.deterministic,
              backends.cudnn.benchmark)
    with model_precision(conv="ieee"):
        during = (backends.cudnn.rnn.fp32_precision, backends.cudnn.fp32_precision,
                  backends.fp32_precision, matmul_flags(), backends.cudnn.deterministic,
                  backends.cudnn.benchmark)
    assert during == before


class Stub:
    """Stands for a trainer or the app runner: records the precision the
    model work would run at, does nothing else."""

    seen = []

    def __init__(self, *args, **kwargs):
        Stub.seen.append(conv_precision())
        self.is_main = True

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


CLI_COMMANDS = {
    "train": ["train", "--data_dir", "d", "--sample_data_dir", "d", "--no_progress_bar"],
    "train-diffusion": ["train-diffusion", "--data_dir", "d"],
    "sample": ["sample", "--milestone", "final"],
    "app": ["app", "gusset", "--checkpoint", "c"],
}


@pytest.mark.parametrize("outer", [None, "ieee"])
@pytest.mark.parametrize("command", list(CLI_COMMANDS))
def test_cli_logs_the_precision(monkeypatch, capsys, command, outer):
    """Each command that runs the model prints, on one line, the precision
    its entry points then run under (the trainers and the runner stubbed)."""

    def run_application(*args, **kwargs):
        Stub()
        return {}

    monkeypatch.setattr(trainer, "Trainer", Stub)
    monkeypatch.setattr(diffusion_trainer, "DiffusionTrainer", Stub)
    monkeypatch.setattr(runner, "run_application", run_application)
    Stub.seen.clear()
    argv = ["--device", "cpu", *CLI_COMMANDS[command]]
    if outer is None:
        cli.main(argv)
    else:
        with model_precision(conv=outer):
            cli.main(argv)
    want = outer or DEFAULT_CONV
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "f32 convolutions" in ln]
    assert lines == [f"{command}: the model's f32 convolutions run at {want} "
                     "(fea_tpu_torch/utils/precision.py)"]
    assert Stub.seen == [want]


def test_app_without_a_checkpoint_logs_no_precision(monkeypatch, capsys):
    monkeypatch.setattr(runner, "run_application", lambda *a, **k: {})
    cli.main(["--device", "cpu", "app", "gusset"])
    assert "convolutions" not in capsys.readouterr().out


# ---- the card -----------------------------------------------------------

def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


def one_bf16_pass(model):
    """A copy of `model` whose convolutions take one bf16 pass: weights and
    inputs rounded to bf16, the sums in f32; everything else unchanged."""
    model = copy.deepcopy(model)
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.weight.data = m.weight.data.bfloat16().float()
            m.register_forward_pre_hook(lambda _, args: (args[0].bfloat16().float(), *args[1:]))
    return model


@pytest.mark.gpu
def test_tf32_forward_within_the_bf16_route():
    """Full width on the card: the FDNUNet forward (256 px, batch 2) and
    `predict` (256 px, batch 4) at "tf32" against "ieee", each bound by
    its bf16 setting's difference from "ieee" and different from it."""
    device = cuda_or_skip()
    rng = np.random.default_rng(0)
    g = torch.Generator(device=device).manual_seed(0)

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)

    model = make_diffusion_model(image_size=256, input_dim=64, num_stages=4, timesteps=1000,
                                 use_flash_attention=True, device=device, generator=g).model.eval()
    x, cond, t = draw(2, 256, 256, 2), draw(2, 256, 256, 5), torch.full((2,), 999.0, device=device)
    with torch.no_grad():
        with model_precision(conv="ieee"):
            strict = model(x, cond, time=t)
        with model_precision(conv="tf32"):
            tf32 = model(x, cond, time=t)
        with model_precision(conv="ieee"):
            bf16 = one_bf16_pass(model)(x, cond, time=t)
    fdnunet = max_abs(tf32, strict), max_abs(bf16, strict)
    del model

    encoder, decoder, _ = create_models(input_dim=64, image_height=256, image_width=256,
                                        num_channels=2, num_auxiliary_condition_channels=3,
                                        num_stages=4, device=device, generator=g)
    inputs = (draw(4, 256, 256, 2), draw(4, 256, 256, 3),
              torch.where(draw(4, 256, 256, 1) > 0, 1.0, -1.0))
    with model_precision(conv="ieee"):
        strict = predict(encoder, decoder, *inputs)
        bf16 = predict(copy.deepcopy(encoder).to(torch.bfloat16),
                       copy.deepcopy(decoder).to(torch.bfloat16),
                       inputs[0].bfloat16(), inputs[1].bfloat16(), inputs[2])
    with model_precision(conv="tf32"):
        tf32 = predict(encoder, decoder, *inputs)
    predictor = max_abs(tf32, strict), max_abs(bf16, strict)
    print(f"max abs diff from ieee: FDNUNet tf32 {fdnunet[0]:.3e}, bf16 {fdnunet[1]:.3e}; "
          f"predict tf32 {predictor[0]:.3e}, bf16 {predictor[1]:.3e}")
    for tf32_diff, bf16_diff in (fdnunet, predictor):
        assert 0 < tf32_diff <= bf16_diff
