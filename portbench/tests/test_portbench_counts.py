"""The operation and byte counts against hand counts."""

import torch

from portbench.counts import flops, kernels
from portbench.reference import fdnunet


def ddpm_config(size=256, input_dim=64):
    return {"model": {"kind": "ddpm", "image_size": size, "input_dim": input_dim,
                      "num_stages": 4, "num_channels": 2,
                      "num_auxiliary_condition_channels": 5, "num_groups": 8,
                      "num_attention_heads": 4, "attention_head_dim": 32}}


def regression_config(size=256):
    return {"model": {"kind": "regression", "image_size": size, "input_dim": 64,
                      "num_stages": 4, "num_channels": 2,
                      "num_auxiliary_condition_channels": 3, "num_groups": 8}}


def test_flash_call_by_hand():
    ops, nbytes = kernels.flash_call(2, 3, 5, 4)
    assert ops == 2 * (2 * 2 * 3 * 5 * 4)  # q k^T and p v, 2 operations a product
    assert nbytes == 4 * 4 * 2 * (3 + 5 + 5 + 3)  # q, k, v, o at D 4, BH 2, f32


def test_flash_bound_at_the_cell_shape():
    ops, nbytes = kernels.flash_call(8, 1024, 1028, 32)
    assert abs(ops - 1.078e9) / 1.078e9 < 1e-3
    assert abs(kernels.bound_s(ops, nbytes) * 1e3 - 0.0022) < 1e-4  # operations bind


def test_group_norm_bwd_bytes_by_hand():
    assert kernels.gn_silu_bwd_call(2, 8, 16) == 4 * (3 * 2 * 8 * 16 + 4 * 2 * 8 + 4 * 8)


def test_call_shapes_of_the_cells():
    flash, gn = kernels.call_shapes(ddpm_config(), 2)
    assert flash == [(8, 1024, 1028, 32)] * 3
    assert len(gn) == 9  # every block2 of the decoder and the final block
    _, gn = kernels.call_shapes(regression_config(), 16)
    by_shape = {}
    for b, c, hw in gn:
        by_shape[(hw, c)] = by_shape.get((hw, c), 0) + 1
    assert by_shape == {(65536, 64): 6, (16384, 128): 4, (4096, 256): 4, (1024, 512): 4}
    total = sum(kernels.gn_silu_bwd_call(*s) for s in gn)
    assert abs(total / kernels.HBM_BYTES_PER_S * 1e3 - 2.2837) < 0.01  # chip_smoke's bound


def test_flops_of_one_convolution_by_hand():
    conv = torch.nn.Conv2d(3, 5, 3, padding=1, device="meta")
    x = torch.empty((2, 3, 8, 8), device="meta")
    with torch.utils.flop_counter.FlopCounterMode(display=False) as counter:
        conv(x)
    assert counter.get_total_flops() == 2 * 2 * 8 * 8 * 5 * 3 * 9


def test_forward_flops_at_full_size():
    # PR 1's FlopCounterMode count of the program's forward: 770 GFLOP
    assert abs(flops.forward_flops(ddpm_config(), 2) / 770e9 - 1) < 0.01


def test_train_step_flops_at_full_size():
    # about three forwards' worth: forward, and the backward's two products
    step = flops.train_step_flops(regression_config(), 16)
    assert 15e12 < step < 20e12


def test_reference_builds_for_every_kind():
    assert set(fdnunet.build(regression_config(32))) == {"encoder", "decoder"}
    assert set(fdnunet.build(ddpm_config(32, 8))) == {"model"}
