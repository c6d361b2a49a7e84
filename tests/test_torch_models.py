"""Parity of the PyTorch port's models (fea_tpu_torch.models) with fea_tpu.

Each test builds a fea_tpu flax module, perturbs its biases and norm gains
away from their zero/one init (so that the conversion of every leaf is
exercised), loads the same params into the port with convert.load_flax,
feeds both the same numpy inputs and compares the outputs in float32 on the
CPU. Tolerance: atol 2e-5 / rtol 1e-4 unless a test states otherwise; the
two frameworks differ only in the order of summation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fea_tpu.models import attention as jattention
from fea_tpu.models import blocks as jblocks
from fea_tpu.models import fdnunet as jfdnunet
from fea_tpu.models import time_embedding as jtime
from fea_tpu_torch.models import attention, blocks, fdnunet, time_embedding
from fea_tpu_torch.models.convert import from_flax, load_flax

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4


def normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def perturb(params, seed=0):
    """Add N(0, 0.1) to every bias, GroupNorm scale and RMSNorm gain."""
    rng = np.random.default_rng(seed)

    def leaf(path, value):
        value = np.asarray(value, np.float32)
        if path[-1].key in ("bias", "scale", "g"):
            value = value + 0.1 * rng.normal(size=value.shape).astype(np.float32)
        return value

    return jax.tree_util.tree_map_with_path(leaf, params)


def flax_init(module, *args, seed=0, **kw):
    """f32 params (perturbed) of a flax module, initialised without x64."""
    with jax.enable_x64(False):
        variables = module.init(jax.random.PRNGKey(seed), *args, **kw)
    return perturb(variables["params"], seed)


def flax_apply(module, params, *args, **kw):
    with jax.enable_x64(False):
        return module.apply({"params": params}, *args, **kw)


def port(cls, params, *args, **kw):
    with torch.device("meta"):
        module = cls(*args, **kw)
    return load_flax(module, params, device="cpu").eval()


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def to_np_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def assert_close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def test_downsample_channel_order():
    x = normal(0, 2, 8, 8, 6)
    jm = jblocks.Downsample(10)
    params = flax_init(jm, x)
    tm = port(blocks.Downsample, params, 6, 10)
    with torch.no_grad():
        got = to_np_nhwc(tm(nchw(x)))
    assert_close(got, flax_apply(jm, params, x))


def test_upsample():
    x = normal(1, 2, 4, 4, 6)
    jm = jblocks.Upsample(5)
    params = flax_init(jm, x)
    tm = port(blocks.Upsample, params, 6, 5)
    with torch.no_grad():
        got = to_np_nhwc(tm(nchw(x)))
    assert_close(got, flax_apply(jm, params, x))


def test_rmsnorm():
    x = normal(2, 2, 4, 4, 12)
    jm = jattention.RMSNorm()
    params = flax_init(jm, x)
    tm = port(attention.RMSNorm, params, 12)
    with torch.no_grad():
        got = to_np_nhwc(tm(nchw(x)))
    assert_close(got, flax_apply(jm, params, x))


def test_amax_normalize_matches_and_guards_zero():
    x = normal(3, 2, 8, 8, 3)
    z = -np.abs(normal(4, 1, 4, 4, 2))
    z[0, 0, 0, :] = 0.0
    for a in (x, z):
        with jax.enable_x64(False):
            want = jblocks.amax_normalize(jnp.asarray(a))
        got = to_np_nhwc(blocks.amax_normalize(nchw(a)))
        assert np.isfinite(got).all()
        assert_close(got, want)


def test_linear_attention():
    x = normal(5, 2, 4, 4, 16)
    jm = jattention.LinearAttention(num_heads=2, head_dim=8)
    params = flax_init(jm, x)
    tm = port(attention.LinearAttention, params, 16, num_heads=2, head_dim=8)
    with torch.no_grad():
        got = to_np_nhwc(tm(nchw(x)))
    assert_close(got, flax_apply(jm, params, x))


@pytest.mark.parametrize("use_flash", [False, True])
def test_full_attention(use_flash):
    """Memory-KV slots first, heads from channels as head * hd + d; the
    flash path is the Pallas kernel (interpret mode) against the port's
    wrapper on CPU tensors."""
    x = normal(6, 2, 4, 4, 16)
    jm = jattention.FullAttention(num_heads=2, head_dim=32, use_flash=use_flash)
    params = flax_init(jm, x)
    tm = port(
        attention.FullAttention, params, 16, num_heads=2, head_dim=32,
        use_flash=use_flash,
    )
    with torch.no_grad():
        got = to_np_nhwc(tm(nchw(x)))
    assert_close(got, flax_apply(jm, params, x))


def test_feature_denormalization():
    x, f = normal(7, 2, 8, 8, 16), normal(8, 2, 8, 8, 12)
    jm = jblocks.FeatureDenormalization(num_groups=8)
    params = flax_init(jm, x, f)
    tm = port(blocks.FeatureDenormalization, params, 16, 12, 8)
    with torch.no_grad():
        got = to_np_nhwc(tm(nchw(x), nchw(f)))
    assert_close(got, flax_apply(jm, params, x, f))


def test_condition_feature_extractor():
    x = normal(9, 1, 16, 16, 3)
    dims = [8, 8, 16, 32]
    jm = jblocks.ConditionFeatureExtractor(dims)
    params = flax_init(jm, x)
    tm = port(blocks.ConditionFeatureExtractor, params, 3, dims)
    with torch.no_grad():
        got = [to_np_nhwc(f) for f in tm(nchw(x))]
    want = flax_apply(jm, params, x)
    assert len(got) == len(want) == len(dims)
    for g, w in zip(got, want):
        assert_close(g, w)


@pytest.mark.parametrize("use_fdn", [True, False])
def test_conditioned_resnet_block(use_fdn):
    """FDN + lean sub-blocks (use_fdn) or GroupNorm sub-blocks, each with a
    time embedding and a residual 1x1 conv (8 -> 16 channels)."""
    x, f, temb = normal(10, 2, 8, 8, 8), normal(11, 2, 8, 8, 12), normal(12, 2, 24)
    jm = jblocks.ConditionedResnetBlock(16, use_fdn=use_fdn, num_groups=4)
    feats = f if use_fdn else None
    params = flax_init(jm, x, feats, temb)
    tm = port(
        blocks.ConditionedResnetBlock, params, 8, 16, use_fdn=use_fdn,
        num_groups=4, feature_dim=12 if use_fdn else None, time_dim=24,
    )
    with torch.no_grad():
        got = to_np_nhwc(tm(
            nchw(x), nchw(f) if use_fdn else None, torch.from_numpy(temb)
        ))
    assert_close(got, flax_apply(jm, params, x, feats, temb))


def test_time_embedding_mlp():
    t = np.array([0.0, 3.0, 7.0, 999.0], np.float32)
    jm = jtime.TimeEmbeddingMLP(16)
    params = flax_init(jm, t)
    tm = port(time_embedding.TimeEmbeddingMLP, params, 16)
    with torch.no_grad():
        got = tm(torch.from_numpy(t)).numpy()
    assert_close(got, flax_apply(jm, params, t))


def test_auxiliary_range_predictor_flatten_order():
    """fea_tpu flattens NHWC; the port must permute back before flatten."""
    x = normal(13, 2, 4, 4, 8)
    jm = jblocks.AuxiliaryRangePredictor(output_dim=4, hidden_dim=32)
    params = flax_init(jm, x)
    tm = port(blocks.AuxiliaryRangePredictor, params, 4 * 4 * 8, 4, hidden_dim=32)
    with torch.no_grad():
        sign, log = tm(nchw(x))
    want_sign, want_log = flax_apply(jm, params, x)
    assert_close(sign.numpy(), want_sign)
    assert_close(log.numpy(), want_log)


def test_from_flax_rejects_unknown_leaf():
    with pytest.raises(ValueError):
        from_flax({"Conv_0": {"kernel": np.zeros((3,), np.float32)}})


@pytest.fixture(scope="module")
def trio():
    """fea_tpu's encoder / decoder / aux at input_dim 16, 32 px, 4 stages,
    and the port's, with the same params."""
    S, B = 32, 2
    kw = dict(
        input_dim=16, image_height=S, image_width=S, num_channels=2,
        num_auxiliary_condition_channels=3, num_stages=4,
    )
    jenc, jdec, jaux = jfdnunet.create_models(**kw)
    materials, conditions = normal(20, B, S, S, 2), normal(21, B, S, S, 3)
    geometry = np.where(normal(22, B, S, S, 1) > 0, 1.0, -1.0).astype(np.float32)
    pe = flax_init(jenc, materials, conditions, seed=1)
    x, hidden, residual = flax_apply(jenc, pe, materials, conditions)
    pd = flax_init(jdec, x, list(hidden), residual, seed=2)
    pa = flax_init(jaux, x, seed=3)

    tenc = port(
        fdnunet.FDNUNetEncoder, pe, 16, num_stages=4, num_channels=2,
        num_auxiliary_condition_channels=3,
    )
    tdec = port(fdnunet.FDNUNetDecoder, pd, 16, num_stages=4, num_channels=2)
    taux = port(fdnunet.FDNUNetAuxDecoder, pa, 16 * 8, 2, S, S, num_stages=4)
    return dict(
        jax=(jenc, jdec, jaux), params=(pe, pd, pa), torch=(tenc, tdec, taux),
        inputs=(materials, conditions, geometry),
    )


def test_trio_and_predict(trio):
    """Encoder (middle, 8 hidden states, residual), aux heads, decoder and
    the geometry-remasked prediction of fea_tpu/apps/runner.py:320-331."""
    jenc, jdec, jaux = trio["jax"]
    pe, pd, pa = trio["params"]
    tenc, tdec, taux = trio["torch"]
    materials, conditions, geometry = trio["inputs"]

    x, hidden, residual = flax_apply(jenc, pe, materials, conditions)
    image = flax_apply(jdec, pd, x, list(hidden), residual)
    sign, log = flax_apply(jaux, pa, x)
    want = ((image + 1.0) / 2.0 * (geometry + 1.0) / 2.0) * 2.0 - 1.0

    tm, tc, tg = (torch.from_numpy(a) for a in (materials, conditions, geometry))
    with torch.no_grad():
        tx, thidden, tresidual = tenc(tm, tc)
        tsign, tlog = taux(tx)
    assert_close(tx.numpy(), x)
    assert len(thidden) == len(hidden) == 8
    for got, w in zip(thidden, hidden):
        assert_close(got.numpy(), w)
    assert_close(tresidual.numpy(), residual)
    assert_close(tsign.numpy(), sign)
    assert_close(tlog.numpy(), log)
    got = fdnunet.predict(tenc, tdec, tm, tc, tg)
    assert got.shape == (2, 32, 32, 2)
    assert_close(got.numpy(), want)


def test_fdnunet_time_embedding_flash():
    """The monolithic FDNUNet with time embedding and flash attention
    (input_dim 16, 2 stages, 32 px): atol 5e-4, the bound fea_tpu's own
    test holds flash against math to (tests/test_models.py:252)."""
    S = 32
    kw = dict(
        input_dim=16, num_stages=2, num_channels=2,
        num_auxiliary_condition_channels=5, use_time_embedding=True,
        use_flash_attention=True,
    )
    jm = jfdnunet.FDNUNet(**kw)
    x, cond = normal(30, 2, S, S, 2), normal(31, 2, S, S, 5)
    t = np.array([3.0, 6.0], np.float32)
    params = flax_init(jm, x, cond, time=t)
    with jax.enable_x64(False):
        want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(params, x, cond, None, t)
    tm = port(fdnunet.FDNUNet, params, **kw)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(cond), time=torch.from_numpy(t))
    assert got.shape == (2, S, S, 2)
    assert_close(got.numpy(), want, atol=5e-4, rtol=0)


@pytest.mark.parametrize("x_self_condition", [False, True])
def test_encoder_self_condition(x_self_condition):
    """FDNUNetEncoder with num_condition_channels (input_dim 16, 2 stages,
    32 px): the initial conv takes x and the self-condition (zeros when
    absent), 2 * num_channels inputs, and every output matches."""
    S = 32
    kw = dict(input_dim=16, num_stages=2, num_channels=2, num_auxiliary_condition_channels=3,
              num_condition_channels=2)
    jm = jfdnunet.FDNUNetEncoder(**kw)
    x, cond = normal(40, 2, S, S, 2), normal(41, 2, S, S, 3)
    extra = (normal(42, 2, S, S, 2),) if x_self_condition else ()
    params = flax_init(jm, x, cond, *extra, seed=4)
    assert params["initial_conv"]["kernel"].shape == (3, 3, 4, 16)
    want = flax_apply(jm, params, x, cond, *extra)
    tm = port(fdnunet.FDNUNetEncoder, params, **kw)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (x, cond, *extra)))
    for g, w in zip(jax.tree_util.tree_leaves((got[0], got[1], got[2])),
                    jax.tree_util.tree_leaves(want)):
        assert_close(g.numpy(), w)


@pytest.mark.parametrize("option", ["use_full_attention", "num_condition_channels"])
def test_fdnunet_options(option):
    """The monolithic FDNUNet (input_dim 16, 2 stages, 32 px, time
    embedding) with full attention at every stage (fea_tpu's flash kernel
    in interpret mode; the port's wrapper takes its plain version on CPU
    tensors: 4 FullAttention sites instead of 2) or with the
    self-conditioning input."""
    S = 32
    kw = dict(
        input_dim=16, num_stages=2, num_channels=2, num_auxiliary_condition_channels=5,
        use_time_embedding=True,
    )
    if option == "use_full_attention":
        kw.update(use_full_attention=True, use_flash_attention=True)
    else:
        kw.update(num_condition_channels=2)
    jm = jfdnunet.FDNUNet(**kw)
    x, cond, self_cond = normal(50, 2, S, S, 2), normal(51, 2, S, S, 5), normal(52, 2, S, S, 2)
    t = np.array([3.0, 6.0], np.float32)
    # the same param tree, initialised through the math path (the flash
    # kernel in interpret mode runs once per call, in the apply below)
    params = flax_init(jfdnunet.FDNUNet(**{**kw, "use_flash_attention": False}), x, cond,
                       time=t, seed=5)
    tm = port(fdnunet.FDNUNet, params, **kw)
    full = [n for n, m in tm.named_modules() if isinstance(m, attention.FullAttention)]
    if option == "use_full_attention":
        assert full == ["down0_attention", "down1_attention", "middle_attention",
                        "up0_attention", "up1_attention"]
    else:
        assert full == ["down1_attention", "middle_attention", "up0_attention"]
    cases = [None] if option == "use_full_attention" else [None, self_cond]
    for sc in cases:
        with jax.enable_x64(False):
            want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(params, x, cond, sc, t)
        with torch.no_grad():
            got = tm(torch.from_numpy(x), torch.from_numpy(cond),
                     None if sc is None else torch.from_numpy(sc), time=torch.from_numpy(t))
        assert_close(got.numpy(), want)


def test_gaussian_diffusion_stores_self_condition():
    """GaussianDiffusion(self_condition=) is stored, as fea_tpu stores it
    (fea_tpu reads it nowhere; the port's loss and sampler feed the x0
    estimate, tests/test_torch_selfcond.py, to a model that takes it)."""
    from fea_tpu.models import diffusion as jdiffusion
    from fea_tpu_torch.models import diffusion

    kw = dict(input_dim=8, num_stages=2, num_channels=2, num_auxiliary_condition_channels=5,
              use_time_embedding=True)
    for flag in (False, True):
        with torch.device("meta"):
            tm = fdnunet.FDNUNet(**kw, num_condition_channels=2 if flag else None)
        ours = diffusion.GaussianDiffusion(tm.to_empty(device="cpu"), timesteps=10, self_condition=flag)
        theirs = jdiffusion.GaussianDiffusion(jfdnunet.FDNUNet(**kw), timesteps=10, self_condition=flag)
        assert ours.self_condition is theirs.self_condition is flag
    assert not diffusion.GaussianDiffusion(tm, timesteps=10).self_condition
