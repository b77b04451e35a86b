"""The port's InceptionV3 pool3 network (micro_diffusion_tpu_torch/eval/inception.py)
against the JAX package's (micro_diffusion_tpu/eval/inception.py) on
``synthetic_params(0)``: pool3 at 75x75 (every block, down to the 1x1 maps of
Mixed_7x), the feature function from 64x64 (up-scaling) and 512x512 (down-scaling),
the bilinear resize itself, and the pt_inception state-dict names and loading.

Tolerance: max |port - JAX| over the largest feature, 1e-5 (fp32 on both sides; the
convolutions sum in other orders)."""

import jax
import numpy as np
import pytest
import torch

from micro_diffusion_tpu.eval import inception as jinc
from micro_diffusion_tpu_torch.eval import inception as tinc

TOL = 1e-5


def rel_max(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def params():
    p = tinc.synthetic_params(0)
    ref = jinc.synthetic_params(0)
    assert p.keys() == ref.keys() and all(np.array_equal(p[k], ref[k]) for k in p)
    return p


@pytest.fixture(scope="module")
def net(params):
    return tinc.build_inception(params, device="cpu")


def test_parameter_table_and_state_dict_names(net):
    """The port's module carries exactly pt_inception's pool3 names and shapes."""
    assert list(tinc.parameter_shapes().items()) == list(jinc.parameter_shapes().items())
    sd = net.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == tinc.parameter_shapes()


def test_pool3_matches_jax(params, net):
    x = np.random.default_rng(1).uniform(-1, 1, (2, 3, 75, 75)).astype(np.float32)
    ref = np.asarray(jax.jit(jinc.pool3_features)(params, x))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (2, tinc.FEATURE_DIM)
    assert np.abs(ref).max() > 0
    assert rel_max(got, ref) <= TOL


@pytest.mark.parametrize("side", [64, 512])
def test_resize_matches_jax_bilinear(side):
    """F.interpolate(bilinear, align_corners=False, antialias=False) is
    jax.image.resize(bilinear, antialias=False), up-scaling and down-scaling."""
    x = np.random.default_rng(side).uniform(0, 1, (2, 3, side, side)).astype(np.float32)
    ref = jax.image.resize(x, (2, 3, 299, 299), "bilinear", antialias=False)
    got = tinc.preprocess(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), 2.0 * np.asarray(ref) - 1.0, rtol=0, atol=2e-6)
    same = np.random.default_rng(0).uniform(0, 1, (1, 3, 299, 299)).astype(np.float32)
    assert torch.equal(tinc.preprocess(torch.from_numpy(same)), torch.from_numpy(2 * same - 1))


@pytest.mark.parametrize("side", [64, 512])
def test_feature_fn_matches_jax(params, side):
    imgs = np.random.default_rng(2 + side).uniform(0, 1, (2, 3, side, side)).astype(np.float32)
    ref = jinc.make_feature_fn(params)(imgs)
    got = tinc.make_feature_fn(params, device="cpu")(imgs)
    assert got.shape == (2, tinc.FEATURE_DIM) and got.dtype == np.float32
    assert rel_max(got, ref) <= TOL


def test_feature_fn_turns_cudnn_tf32_off_only_inside(params, monkeypatch):
    """The forward runs with cuDNN's TF32 off; the process-wide flag is as it was
    before and after."""
    seen = []
    fn = tinc.make_feature_fn(params, device="cpu")
    monkeypatch.setattr(tinc.InceptionPool3, "forward",
                        lambda self, x: seen.append(torch.backends.cudnn.allow_tf32)
                        or x.new_zeros(x.shape[0], tinc.FEATURE_DIM))
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        fn(np.zeros((1, 3, 299, 299), np.float32))
        assert seen == [False] and torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = before


def test_load_params_strict(tmp_path, params):
    """A .pth with the pool3 keys plus aux/fc heads and BN counters loads: the heads
    and counters are dropped, the rest loads into the module with strict=True; a
    wrong shape or a missing key is refused."""
    sd = {k: torch.from_numpy(v) for k, v in params.items()}
    sd["fc.weight"] = torch.zeros(1008, 2048)
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    sd["Conv2d_1a_3x3.bn.num_batches_tracked"] = torch.tensor(0)
    path = tmp_path / "pt_inception.pth"
    torch.save(sd, path)
    loaded = tinc.load_params(str(path))
    assert loaded.keys() == params.keys()
    assert all(np.array_equal(loaded[k], params[k]) for k in params)
    ref = jinc.load_params(str(path))
    assert all(np.array_equal(loaded[k], ref[k]) for k in ref)
    tinc.InceptionPool3().load_state_dict({k: torch.from_numpy(v) for k, v in loaded.items()},
                                          strict=True)

    bad = dict(sd, **{"Conv2d_1a_3x3.conv.weight": torch.zeros(1, 1, 1, 1)})
    torch.save(bad, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="shape"):
        tinc.load_params(str(tmp_path / "bad.pth"))
    del sd["Mixed_7c.branch_pool.bn.running_var"]
    torch.save(sd, tmp_path / "missing.pth")
    with pytest.raises(ValueError, match="missing"):
        tinc.load_params(str(tmp_path / "missing.pth"))


def test_feature_fn_needs_the_card_unless_asked(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tinc.make_feature_fn(params)
