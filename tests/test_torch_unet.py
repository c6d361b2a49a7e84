"""Parity of the port's plain conditional UNet (fea_tpu_torch.models.unet)
with fea_tpu's, in float32 on the CPU.

A param tree of the flax module's shapes is filled from a seed (biases and
norm gains away from zero / one) and loaded into the port through
convert.load_flax; both get the same numpy inputs. Tolerance: 5e-4
absolute for the whole model (the amax-normalised output lies in [-1, 1]),
the bound tests/test_torch_models.py holds FDNUNet to; the modules UNet is
built from are held to atol 2e-5 / rtol 1e-4 there, and the input stack
(x, self-condition, condition, in that channel order) here.
"""

import jax
import numpy as np
import pytest
import torch

from fea_tpu.models import unet as junet
from fea_tpu_torch.models import UNet
from fea_tpu_torch.models.convert import load_flax

torch.set_num_threads(1)

S = 16


def normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def random_params(module, *args, **kw):
    """A param tree of the module's shapes (traced, not run: flax's own
    init would compile every op), filled from a seed: kernels and memory
    slots N(0, 1 / fan-in), biases N(0, 0.1), norm gains 1 + N(0, 0.1), so
    that every leaf's conversion shows in the output."""
    rng = np.random.default_rng(0)

    def leaf(path, a):
        value = rng.normal(size=a.shape).astype(np.float32)
        name = path[-1].key
        if name == "bias":
            return 0.1 * value
        if name in ("scale", "g"):
            return 1.0 + 0.1 * value
        return value / np.sqrt(np.prod(a.shape[:-1]), dtype=np.float32)

    with jax.enable_x64(False):
        abstract = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kw)["params"]
    return jax.tree_util.tree_map_with_path(leaf, abstract)


def both(kw, calls):
    """[(port's output, fea_tpu's output)] for each argument tuple (x,
    x_condition, x_self_condition, time) of `calls`, from one set of
    params."""
    jm = junet.UNet(**kw)
    params = random_params(jm, *calls[0])
    with torch.device("meta"):
        tm = UNet(**kw)
    tm = load_flax(tm, params, device="cpu").eval()
    out = []
    for args in calls:
        with jax.enable_x64(False):
            want = jax.jit(jm.apply)({"params": params}, *args)
        with torch.no_grad():
            got = tm(*(None if a is None else torch.from_numpy(a) for a in args))
        out.append((got.numpy(), np.asarray(want)))
    return out


@pytest.mark.parametrize("self_condition", [True, False])
def test_unet_matches_fea_tpu(self_condition):
    """Time embedding, condition channels, linear attention at the outer
    stage and full attention at the innermost and the middle. With
    self-conditioning: the self-condition given, and absent (zeros take
    its place)."""
    kw = dict(
        input_dim=16, num_stages=2, num_channels=2, num_condition_channels=3,
        self_condition=self_condition, num_groups=4, attention_head_dim=8,
        num_attention_heads=2, use_time_embedding=True,
    )
    x, cond = normal(1, 2, S, S, 2), normal(2, 2, S, S, 3)
    time = np.array([3.0, 41.0], np.float32)
    calls = [(x, cond, None, time)]
    if self_condition:
        calls.insert(0, (x, cond, normal(3, 2, S, S, 2), time))
    results = both(kw, calls)
    for got, want in results:
        assert got.shape == want.shape == (2, S, S, 2)
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    if self_condition:  # the argument is read, not dropped
        assert np.abs(results[0][0] - results[1][0]).max() > 1e-3


def test_unet_full_attention_three_stages_no_condition():
    """use_full_attention at every stage, three stages (a Downsample and
    an Upsample in the middle of the chain), final_dim, no condition, no
    time embedding."""
    kw = dict(
        input_dim=8, initial_dim=12, final_dim=3, num_stages=3, num_channels=2,
        num_groups=4, attention_head_dim=8, num_attention_heads=2, use_full_attention=True,
    )
    ((got, want),) = both(kw, [(normal(4, 1, S, S, 2), None, None, None)])
    assert got.shape == want.shape == (1, S, S, 3)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_unet_input_checks():
    with torch.device("meta"):
        tm = UNet(input_dim=8, num_stages=3, num_channels=2, num_condition_channels=3)
    with pytest.raises(ValueError, match="divisible"):
        tm(torch.zeros(1, 6, 8, 2, device="meta"), torch.zeros(1, 6, 8, 3, device="meta"))
    with pytest.raises(ValueError, match="x_condition is required"):
        tm(torch.zeros(1, 8, 8, 2, device="meta"))
