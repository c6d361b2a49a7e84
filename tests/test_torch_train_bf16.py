"""The port's regression Trainer step under compute_dtype="bfloat16"
against fea_tpu's, on the CPU, with the set-up of tests/test_torch_train.py
(in a file of its own: each fea_tpu train step takes some 20 s of XLA
compilation, and a file runs on one test worker)."""

import jax
import numpy as np
import torch

from fea_tpu_torch.models.blocks import ResnetSubBlock
from test_torch_train import (  # noqa: F401 (the folder fixture)
    MODULES, adam_moments, folder, jax_trainer, port_moments, port_trainer,
)

torch.set_num_threads(1)


def test_trainer_bf16_step_matches_fea_tpu(folder, tmp_path):
    """compute_dtype='bfloat16' in both, from the same f32 params and batch:
    bf16 rounds at different places in the two frameworks (flax normalises
    in f32 and applies SiLU in bf16; the port's fused op rounds once), so
    the loss agrees to rtol 2e-2 and each module's gradient (Adam's first
    moment) to 0.15 of its norm (measured 0.04-0.08: each bf16 rounding is
    2^-8 relative, and the backward chains some forty of them); params
    keep f32 masters in both. That bound alone would pass a port that ran
    the step in f32, so the step also records the dtype that every
    GroupNorm sub-block and every module head takes and returns: bf16."""
    pt = port_trainer(folder, tmp_path, "bf16", compute_dtype="bfloat16")
    jt = jax_trainer(folder, tmp_path / "jax", pt, compute_dtype="bfloat16")
    with jax.enable_x64(False):
        jbatch = jt._fetch_batch(0)
        state, jloss = jt._train_step(jt.state, jbatch)
    pbatch = pt._fetch_batch(0)
    assert pbatch["forces"].dtype == torch.bfloat16 and pbatch["geometry"].dtype == torch.int8
    seen = []

    def record(name):
        def hook(module, args, out):
            outs = out if isinstance(out, tuple) else (out,)
            seen.append((name, args[0].dtype, *(o.dtype for o in outs)))
        return hook

    hooks = [pt.modules[k].register_forward_hook(record(k)) for k in ("decoder", "auxiliary")]
    hooks += [
        m.register_forward_hook(record(f"{k}.{n}"))
        for k in MODULES for n, m in pt.modules[k].named_modules()
        if isinstance(m, ResnetSubBlock)
    ]
    loss = pt._train_step(pbatch)
    for h in hooks:
        h.remove()
    assert sum(name.startswith("decoder.") for name, *_ in seen) >= 2
    assert all(set(dtypes) == {torch.bfloat16} for _, *dtypes in seen), seen
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)
    rel = {}
    for key in MODULES:
        _, mu, _ = adam_moments(state, key)
        _, pmu, _ = port_moments(pt, key)
        diff = torch.cat([(pmu[k] - mu[k]).flatten() for k in mu])
        norm = torch.cat([mu[k].flatten() for k in mu])
        rel[key] = float(diff.norm() / norm.norm())
        assert all(p.dtype == torch.float32 for p in pt.params[key])
    assert max(rel.values()) < 0.15, rel
