"""The frozen yardstick against the port it was copied from, and the bound
functions on known shapes."""

import numpy as np
import pytest
import torch

from benchlib import bounds, exemplar, flops, reference, schedule


@pytest.mark.parametrize("size, passes, iters", [(512, 5, 500),
                                                 (2048, 5, 500),
                                                 (256, 2, 40)])
def test_schedule_matches_the_port(size, passes, iters):
    from optimaltextures_tpu_torch.utils import schedule as port

    table, sizes = port.iters_and_sizes(size, iters, passes, True,
                                        quirk=True, num_layers=3)
    assert schedule.iters_and_sizes(size, iters, passes, 3) == (table, sizes)
    assert schedule.get_size(sizes[1], 512, 512) == port.get_size(
        sizes[1], 1.0, 512, 512)


def test_pca_rule_matches_the_port():
    from optimaltextures_tpu_torch.transport import choose_k

    rng = np.random.default_rng(0)
    for _ in range(20):
        s = np.sort(rng.gamma(0.3, size=64))[::-1]
        assert schedule.choose_k(s) == choose_k(s)


@pytest.mark.parametrize("size, hw", [(512, (512, 512)), (2048, (2048, 2048))])
def test_flops_match_the_port_at_batch_1(size, hw):
    """The batch-aware copy at batch 1 against the port's run_flops."""
    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.config import OptexConfig
    from optimaltextures_tpu_torch.utils.flops import run_flops

    synth = core.Synthesizer(OptexConfig(size=size, depth=3), device="cpu")
    ks = [[20 + p, 60 + p, 150 + p] for p in range(5)]
    want = run_flops(synth, hw, [(512, 512)], ks)
    got = flops.run_flops(size=size, iters=500, passes=5, depth=3, batch=1,
                          pastiche_hw=hw, style_hw=(512, 512), ks=ks,
                          mode="chol")
    assert got == pytest.approx(want, rel=1e-12)


def test_flops_scale_with_the_batch():
    ks = [[24, 74, 174]] * 5
    kw = dict(size=512, iters=500, passes=5, depth=3, pastiche_hw=(512, 512),
              style_hw=(512, 512), ks=ks, mode="chol")
    one, many = flops.run_flops(batch=1, **kw), flops.run_flops(batch=128, **kw)
    assert 64 * one < many < 128 * one


def test_codec_bounds_on_known_shapes():
    """Batch 128 at 512 px in bf16: kernel 5b moves 4.70 GB (1.4023 ms at
    3.35 TB/s) and the 128-channel upconv 128^2 -> 256^2 does 1.1e12
    FLOPs (1.1117 ms at 989 TF/s), as the port's kernel table has them."""
    lau = bounds.codec_launches(128, 512, 512, 3, 2)
    assert len(lau) == 8
    f, by = lau[0]
    assert f == 2.0 * 128 * 512 * 512 * 27 * 64
    assert by / bounds.PEAK_BYTES * 1e3 == pytest.approx(1.4023, abs=2e-3)
    f_up, _ = lau[4]
    assert f_up / 989e12 * 1e3 == pytest.approx(1.1117, abs=1e-3)
    assert len(bounds.codec_launches(1, 64, 64, 2, 4)) == 6
    assert len(bounds.codec_launches(1, 64, 64, 1, 4)) == 2


def test_call_bounds_count_every_launch():
    plan = schedule.pass_plan(512, 500, 5, 3, (512, 512))
    codec = bounds.call_launches(plan, 128, 3, 2)
    assert len(codec) == 5 * 16
    ks = [[174, 74, 24]] * 5
    cdf = bounds.call_launches(plan, 128, 3, 2, style_hw=(512, 512), ks=ks,
                               kind="cdf")
    assert len(cdf) == 2 * sum(sum(it) for _, _, it in plan)
    assert all(f == 0.0 for f, _ in cdf)


def test_inputs_repeat_from_the_seed():
    a = exemplar.style_exemplar("cpu", 128, 2 ** 31 + 5, 3)
    b = exemplar.style_exemplar("cpu", 128, 2 ** 31 + 5, 3)
    c = exemplar.style_exemplar("cpu", 128, 2 ** 31 + 5, 4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (1, 128, 128, 3) and 0 <= a.min() and a.max() <= 1
    assert torch.equal(exemplar.noise("cpu", (2, 8, 8, 3), 7, 1),
                       exemplar.noise("cpu", (2, 8, 8, 3), 7, 1))
    assert exemplar.run_key(2 ** 40, 0) != exemplar.run_key(2 ** 40, 1)


def test_reference_rotations_are_the_programs():
    from optimaltextures_tpu_torch.ops.rotation import generator, stage_rotations

    want = stage_rotations(generator("cpu", 99, 2, 1), 5, 24, "cpu")
    assert torch.equal(reference.stage_rotations(99, 2, 1, 5, 24, "cpu"), want)


def test_reference_resize_matches_torch():
    x = torch.rand(1, 40, 40, 3, generator=torch.Generator().manual_seed(0))
    for hw in ((24, 24), (64, 64)):
        want = torch.nn.functional.interpolate(
            x.permute(0, 3, 1, 2), size=hw, mode="bicubic", antialias=True,
            align_corners=False).permute(0, 2, 3, 1)
        assert torch.allclose(reference.resize(x, hw), want, atol=1e-5)


def test_controls_round_one_step_lower():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -9, 3.0])
    assert reference.round_tf32(x)[0] == 1.0
    assert reference.round_tf32(x)[1] == x[1]
    assert reference.round_fp8(torch.tensor([1.06, 500.0]))[1] == 448.0
    assert reference.round_fp8(torch.tensor([1.06]))[0] == 1.0


def test_reference_takes_the_programs_eigenvector_signs():
    """A basis whose columns differ from the reference's only in sign gives
    the reference that basis; the columns it lacks keep their sign."""
    v = torch.linalg.qr(torch.randn(
        16, 6, generator=torch.Generator().manual_seed(1)))[0]
    signs = torch.tensor([1.0, -1.0, -1.0, 1.0, -1.0])
    got = reference.align_signs(v, v[:, :5] * signs)
    assert torch.equal(got[:, :5], v[:, :5] * signs)
    assert torch.equal(got[:, 5], v[:, 5])
