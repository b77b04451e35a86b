"""The port's checkpoint converter CLI (micro_diffusion_tpu_torch/models/
convert_checkpoint.py) against the JAX package's: one MicroDiT-Micro .pt made from
JAX params through params_to_torch_state_dict; both CLIs' --out files equal key for
key and value for value; the port's --validate on the meta device for the right and
a wrong architecture; the port's torch_state_dict_to_params against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_diffusion_tpu.models import convert_checkpoint as jconvert
from micro_diffusion_tpu.models import dit as jdit
from micro_diffusion_tpu.models import interop as jinterop
from micro_diffusion_tpu_torch.models import convert_checkpoint as tconvert
from micro_diffusion_tpu_torch.models import interop as tinterop

RES = 8


@pytest.fixture(scope="module")
def micro_pt(tmp_path_factory):
    """A reference-layout .pt of MicroDiT_Micro_2 at latent_res 8 (JAX init, leaves
    moved by seeded noise) and the state dict it holds."""
    model = jdit.MicroDiT_Micro_2(input_size=RES, dtype=jnp.float32)
    rng = jax.random.PRNGKey(0)
    params = jax.jit(lambda: model.init(
        {"params": rng, "mask": rng}, jnp.zeros((1, 4, RES, RES)), jnp.zeros((1,)),
        jnp.zeros((1, 1, 77, 1024))))()
    leaves, tree = jax.tree_util.tree_flatten(params)
    noise = np.random.default_rng(0)
    params = jax.tree_util.tree_unflatten(tree, [
        np.asarray(x) + 0.05 * noise.standard_normal(x.shape).astype(np.float32)
        for x in leaves])
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in jinterop.params_to_torch_state_dict(params).items()}
    path = tmp_path_factory.mktemp("ckpt") / "micro.pt"
    torch.save(sd, str(path))
    return str(path), sd


def test_out_npz_equals_the_jax_cli(micro_pt, tmp_path, capsys):
    path, _ = micro_pt
    jconvert.main(["--checkpoint", path, "--out", str(tmp_path / "jax.npz")])
    tconvert.main(["--checkpoint", path, "--out", str(tmp_path / "port.npz")])
    out = capsys.readouterr().out.splitlines()
    with np.load(tmp_path / "jax.npz") as j, np.load(tmp_path / "port.npz") as t:
        assert list(t.keys()) == list(j.keys())
        assert all(k.startswith("params/") for k in t.keys())
        for k in j.keys():
            assert t[k].dtype == j[k].dtype == np.float32 and t[k].shape == j[k].shape, k
            assert np.array_equal(t[k], j[k]), k
    assert out[0] == out[2] and out[0].startswith("loaded ")  # tensors, params


def test_validate_on_the_meta_device(micro_pt, capsys):
    path, _ = micro_pt
    common = ["--checkpoint", path, "--latent_res", str(RES), "--validate"]
    tconvert.main(common + ["--dit_arch", "MicroDiT_Micro_2"])
    assert "structure matches MicroDiT_Micro_2 exactly" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="Missing key|size mismatch"):
        tconvert.main(common + ["--dit_arch", "MicroDiT_Tiny_2"])


def test_torch_state_dict_to_params_matches_jax(micro_pt):
    _, sd = micro_pt
    sd = dict(sd, mask_token=torch.zeros(1, 1, 64), pos_embed=torch.ones(1, 16, 64))
    got = tinterop.torch_state_dict_to_params(sd)
    ref = jinterop.torch_state_dict_to_params(sd)
    g_flat = tconvert.flatten_params(got)
    r_flat = {"/".join(str(k.key) for k in p): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert list(g_flat) == list(r_flat)
    for k, v in r_flat.items():
        assert np.array_equal(g_flat[k], v), k
    with pytest.raises(ValueError, match="mask_token"):
        tinterop.torch_state_dict_to_params(dict(sd, mask_token=torch.ones(1, 1, 64)))
    with pytest.raises(ValueError, match="unrecognized"):
        tinterop.torch_state_dict_to_params(dict(sd, **{"blocks.0.odd": torch.ones(2)}))
