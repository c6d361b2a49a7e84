"""Training-log parsing and loss-curve plotting (the port's own copy of
fea_tpu/utils/logs.py: NumPy, with matplotlib imported inside the plot).

Equivalent of the reference's plot_logs notebook (test_nbs/plot_logs.ipynb,
SURVEY.md C29): parse `results/train-*.log` lines into step/loss series,
plot train + sample loss with a polynomial trend, optionally re-log to
wandb."""

import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

_STEP_RE = re.compile(r"step: (\d+), loss: ([0-9.eE+-]+)")
_SAMPLE_RE = re.compile(r"sample loss: ([0-9.eE+-]+)")


def parse_train_log(path: str) -> Dict[str, np.ndarray]:
    steps: List[int] = []
    losses: List[float] = []
    sample_losses: List[Tuple[int, float]] = []
    last_step = 0
    with open(path) as f:
        for line in f:
            m = _STEP_RE.search(line)
            if m:
                last_step = int(m.group(1))
                steps.append(last_step)
                losses.append(float(m.group(2)))
                continue
            m = _SAMPLE_RE.search(line)
            if m:
                sample_losses.append((last_step, float(m.group(1))))
    return {
        "steps": np.asarray(steps),
        "losses": np.asarray(losses),
        "sample_steps": np.asarray([s for s, _ in sample_losses]),
        "sample_losses": np.asarray([v for _, v in sample_losses]),
    }


def plot_training_curves(
    log_path: str,
    output_path: Optional[str] = None,
    polyfit_degree: int = 3,
    wandb_run=None,
):
    """Loss curves + polyfit trend; saves a PNG and/or re-logs to wandb."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = parse_train_log(log_path)
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(data["steps"], data["losses"], lw=0.7, alpha=0.6, label="train loss")
    if len(data["steps"]) > polyfit_degree + 1:
        coeffs = np.polyfit(data["steps"], data["losses"], polyfit_degree)
        ax.plot(
            data["steps"],
            np.polyval(coeffs, data["steps"]),
            lw=2,
            label=f"trend (deg {polyfit_degree})",
        )
    if len(data["sample_steps"]):
        ax.plot(
            data["sample_steps"],
            data["sample_losses"],
            "o-",
            ms=3,
            label="sample loss",
        )
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.legend()
    ax.set_title(Path(log_path).name)
    if output_path is None:
        output_path = str(Path(log_path).with_suffix(".png"))
    fig.savefig(output_path, dpi=120, bbox_inches="tight")
    plt.close(fig)

    if wandb_run is not None:
        for s, l in zip(data["steps"], data["losses"]):
            wandb_run.log({"step": int(s), "train_loss": float(l)})
    return output_path
