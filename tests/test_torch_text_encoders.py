"""The port's text encoders, tokenizers and weight readers against the JAX package's
and transformers': CLIP's text tower (both activations, fp32 and bf16) and the T5
encoder against the JAX modules with the JAX weights carried across by the port's
converters; the HF- and OpenCLIP-named state dicts loaded strict into the port
against transformers' own forward; the CLIP BPE tokenizer against transformers'
CLIPTokenizer on one vocabulary; the port's SentencePiece copy against the JAX one;
the safetensors reader against the safetensors package."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_diffusion_tpu.models import text_encoders as jte
from micro_diffusion_tpu.utils import spm as jspm
from micro_diffusion_tpu_torch.models import interop as tinterop
from micro_diffusion_tpu_torch.models import text_encoders as tte
from micro_diffusion_tpu_torch.utils import clip_bpe
from micro_diffusion_tpu_torch.utils import spm as tspm

# fp32: ~1e-4 of the largest entry (the same math, summed in another order); bf16:
# 3e-2 of it (a bf16 ulp is 2^-8 = 4e-3 of an entry, rounded after every product in
# both frameworks, but not always at the same points)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CLIP = dict(vocab_size=1000, width=64, layers=2, heads=4, context_length=77)
T5 = dict(vocab_size=120, d_model=64, num_layers=2, num_heads=4, d_kv=16, d_ff=128)
CAPTIONS = [
    "A photo of a cat sitting on a red mat.",
    "two dogs   playing\tin the\nsnow, 3 of them!!",
    "Café crème brûlée at 10:30 -- naïve ÉCOLE façade",
    "it's the dog's bone; they're here, we've won, I'm ok, we'll see, he'd go",
    "numbers 1234567 and ½ ² 3.14159 #hashtag @user (parens) [brackets] {braces}",
    "an astronaut riding a horse on the moon " * 12,  # longer than 77 tokens
    "日本語のテキスト and 中文 mixed with English",
    "",
]


def rel_max(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def perturbed(params, scale=0.05, seed=0):
    """JAX params with every leaf moved by seeded noise, so that the LayerNorm scales
    and biases, zero at init, are informative."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(tree, [
        np.asarray(leaf) + scale * rng.standard_normal(leaf.shape).astype(np.float32)
        for leaf in leaves])


# ------------------------------------------------------------------------ CLIP


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quick_gelu", [False, True])
def test_clip_matches_jax(quick_gelu, dtype):
    ids = np.random.default_rng(1).integers(0, CLIP["vocab_size"], (2, 77))
    jmod = jte.CLIPTextTransformer(use_quick_gelu=quick_gelu, dtype=JDT[dtype], **CLIP)
    params = perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(0), ids))
    ref = jax.jit(jmod.apply)(params, ids)
    tmod = tte.CLIPTextTransformer(use_quick_gelu=quick_gelu, dtype=TDT[dtype], **CLIP)
    tinterop.load_numpy_state_dict(tmod, tinterop.clip_params_to_state_dict(params))
    with torch.no_grad():
        out = tmod(torch.from_numpy(ids))
    assert out.dtype == TDT[dtype] and out.shape == (2, 77, CLIP["width"])
    assert rel_max(out.float(), ref) <= TOL[dtype]


def _hf_clip(seed=0, act="gelu"):
    from transformers import CLIPTextConfig, CLIPTextModel

    cfg = CLIPTextConfig(vocab_size=99, hidden_size=64, intermediate_size=256,
                         num_hidden_layers=3, num_attention_heads=4,
                         max_position_embeddings=16, hidden_act=act)
    torch.manual_seed(seed)
    return cfg, CLIPTextModel(cfg).eval()


def _openclip_names(sd, layers):
    """The OpenCLIP layout of an HF CLIPTextModel state dict, as
    tests/test_text_encoders.py builds it, plus the keys a full OpenCLIP
    checkpoint adds around the text tower."""
    oc = {"token_embedding.weight": sd["text_model.embeddings.token_embedding.weight"],
          "positional_embedding": sd["text_model.embeddings.position_embedding.weight"],
          "ln_final.weight": sd["text_model.final_layer_norm.weight"],
          "ln_final.bias": sd["text_model.final_layer_norm.bias"],
          "text_projection": torch.zeros(64, 32), "logit_scale": torch.ones(()),
          "visual.proj": torch.zeros(8, 8)}
    for i in range(layers):
        pre, dst = f"text_model.encoder.layers.{i}", f"transformer.resblocks.{i}"
        for p in ("weight", "bias"):
            oc[f"{dst}.ln_1.{p}"] = sd[f"{pre}.layer_norm1.{p}"]
            oc[f"{dst}.ln_2.{p}"] = sd[f"{pre}.layer_norm2.{p}"]
            oc[f"{dst}.attn.in_proj_{p}"] = torch.cat(
                [sd[f"{pre}.self_attn.{x}_proj.{p}"] for x in "qkv"], dim=0)
            oc[f"{dst}.attn.out_proj.{p}"] = sd[f"{pre}.self_attn.out_proj.{p}"]
            oc[f"{dst}.mlp.c_fc.{p}"] = sd[f"{pre}.mlp.fc1.{p}"]
            oc[f"{dst}.mlp.c_proj.{p}"] = sd[f"{pre}.mlp.fc2.{p}"]
    return oc


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_hf_and_openclip_state_dicts_load_strict(act):
    """transformers' CLIPTextModel (tests/test_text_encoders.py's config) loaded
    strict through the HF-name mapping, and its OpenCLIP-named twin, match its
    last_hidden_state (fp32, 2e-4 as the JAX package's test)."""
    _, hf = _hf_clip(act=act)
    ids = torch.tensor([[1, 5, 7, 20, 3, 9, 2] + [0] * 9, [4, 8, 15, 16, 23, 42, 2] + [0] * 9])
    with torch.no_grad():
        ref = hf(ids).last_hidden_state
    sd = hf.state_dict()
    for named in (sd, _openclip_names(sd, 3)):
        tmod = tte.CLIPTextTransformer(vocab_size=99, width=64, layers=3, heads=4,
                                       context_length=16, use_quick_gelu=act == "quick_gelu")
        tte.load_text_encoder_state_dict(tmod, named)
        with torch.no_grad():
            np.testing.assert_allclose(tmod(ids).numpy(), ref.numpy(), rtol=2e-4, atol=2e-4)
    with pytest.raises(RuntimeError, match="Missing key"):
        tte.load_text_encoder_state_dict(tmod, {k: v for k, v in _openclip_names(sd, 3).items()
                                                if "resblocks.2." not in k})


# -------------------------------------------------------------------------- T5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_t5_matches_jax(dtype):
    rng = np.random.default_rng(2)
    ids = rng.integers(1, T5["vocab_size"], (2, 24))
    mask = np.ones_like(ids)
    mask[0, 17:] = 0
    mask[1, 9:] = 0
    ids = ids * mask
    jmod = jte.T5Encoder(dtype=JDT[dtype], **T5)
    params = perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(0), ids, mask))
    ref = jax.jit(jmod.apply)(params, ids, mask)
    tmod = tte.T5Encoder(dtype=TDT[dtype], **T5)
    tinterop.load_numpy_state_dict(tmod, tinterop.t5_params_to_state_dict(params))
    with torch.no_grad():
        out = tmod(torch.from_numpy(ids), torch.from_numpy(mask))
    assert out.dtype == torch.float32 and out.shape == (2, 24, T5["d_model"])
    assert rel_max(out, ref) <= TOL[dtype]


def test_t5_hf_state_dict_loads_strict():
    """transformers' T5EncoderModel (tests/test_text_encoders.py's config) loaded
    strict, with and without the tied table's second name, matches its
    last_hidden_state with a padding mask (fp32, 1e-4)."""
    from transformers import T5Config, T5EncoderModel

    cfg = T5Config(vocab_size=120, d_model=48, d_kv=12, d_ff=96, num_layers=2, num_heads=4,
                   relative_attention_num_buckets=8, relative_attention_max_distance=20,
                   feed_forward_proj="gated-gelu", dropout_rate=0.0)
    torch.manual_seed(0)
    hf = T5EncoderModel(cfg).eval()
    ids = torch.tensor([[3, 7, 12, 99, 5, 1, 0, 0], [8, 14, 2, 1, 0, 0, 0, 0]])
    mask = (ids != 0).long()
    with torch.no_grad():
        ref = hf(ids, attention_mask=mask).last_hidden_state
    sd = hf.state_dict()
    assert "encoder.embed_tokens.weight" in sd and "shared.weight" in sd
    untied = {k: v for k, v in sd.items() if k != "encoder.embed_tokens.weight"}
    for named in (sd, untied):
        tmod = tte.T5Encoder(vocab_size=120, d_model=48, num_layers=2, num_heads=4, d_kv=12,
                             d_ff=96, rel_buckets=8, rel_max_distance=20)
        tte.load_text_encoder_state_dict(tmod, named)
        with torch.no_grad():
            out = tmod(ids, mask)
        assert rel_max(out, ref) <= 1e-4


def test_relative_position_bucket_matches_jax():
    rel = np.arange(-300, 301)[None, :]
    for buckets, dist in ((32, 128), (8, 20)):
        ref = jte.T5Encoder._relative_position_bucket(jnp.asarray(rel), buckets, dist)
        got = tte.relative_position_bucket(torch.from_numpy(rel), buckets, dist)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------------ universal encoder


def test_universal_text_encoder(tmp_path):
    """A local HF snapshot (config.json + a safetensors file written by the
    safetensors package) loads and matches transformers; random weights are
    seeded and finite; no weights_dir raises FileNotFoundError as in JAX."""
    from safetensors.torch import save_file

    cfg, hf = _hf_clip(act="quick_gelu")
    snap = tmp_path / "clip"
    snap.mkdir()
    (snap / "config.json").write_text(cfg.to_json_string())
    save_file({k: v.contiguous() for k, v in hf.state_dict().items()},
              str(snap / "model.safetensors"))
    ids = np.array([[1, 5, 7, 20, 3, 9, 2] + [0] * 9])
    enc = tte.UniversalTextEncoder(str(snap), dtype="float32", device="cpu")
    emb, none = enc.encode(ids)
    assert none is None and emb.shape == (1, 1, 16, 64)
    assert not any(p.requires_grad for p in enc.parameters())
    with torch.no_grad():
        ref = hf(torch.from_numpy(ids)).last_hidden_state
    np.testing.assert_allclose(emb[:, 0].numpy(), ref.numpy(), rtol=2e-4, atol=2e-4)

    rand = lambda seed: tte.UniversalTextEncoder(
        str(snap), dtype="float32", pretrained=False, device="cpu",
        generator=torch.Generator().manual_seed(seed)).encode(ids)[0]
    a, b, c = rand(3), rand(3), rand(4)
    assert torch.isfinite(a).all() and torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(FileNotFoundError, match="weights_dir"):
        tte.UniversalTextEncoder("openclip:hf-hub:apple/DFN5B-CLIP-ViT-H-14-378",
                                 device="cpu")


# ------------------------------------------------------------------ tokenizers


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    corpus = CAPTIONS[:5] + ["a photo of the cat and the dog", "playing in the snow"]
    return clip_bpe.write_bpe_vocab(corpus, str(tmp_path_factory.mktemp("bpe")),
                                    num_merges=150)


@pytest.mark.parametrize("pad", [None, "!"])
def test_clip_bpe_matches_transformers(bpe_dir, tmp_path, pad):
    """ids equal transformers' CLIPTokenizer (without ftfy, as installed) on the same
    vocab.json / merges.txt, padding='max_length' and truncation to 77; with the
    SD2-style pad token '!' too (an added token in transformers)."""
    from transformers import CLIPTokenizer

    d = bpe_dir
    if pad is not None:
        d = str(tmp_path)
        for f in ("vocab.json", "merges.txt"):
            with open(os.path.join(bpe_dir, f), encoding="utf-8") as src:
                (tmp_path / f).write_text(src.read(), encoding="utf-8")
        (tmp_path / "special_tokens_map.json").write_text(json.dumps({"pad_token": pad}))
    hf = CLIPTokenizer(os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt"),
                       **({} if pad is None else {"pad_token": pad}))
    assert hf.fix_text is None  # the path the port reproduces
    ref = hf(CAPTIONS, padding="max_length", max_length=77, truncation=True,
             return_tensors="np")["input_ids"]
    got = clip_bpe.CLIPBPETokenizer(d)(CAPTIONS)["input_ids"]
    assert ref.shape == got.shape == (len(CAPTIONS), 77)
    np.testing.assert_array_equal(got, ref)
    for cap in CAPTIONS:
        assert clip_bpe.CLIPBPETokenizer(d).tokenize(cap) == hf.tokenize(cap)


def test_universal_tokenizer(bpe_dir, tmp_path):
    tok = tte.UniversalTokenizer("openclip:hf-hub:apple/DFN5B-CLIP-ViT-H-14-378", bpe_dir)
    out = tok.tokenize(["a cat", "a dog"])
    assert set(out) == {"input_ids"} and out["input_ids"].shape == (2, 77)
    (tmp_path / "spiece.model").write_bytes(jspm.build_model_proto(PIECES))
    t5 = tte.UniversalTokenizer("DeepFloyd/t5-v1_1-xxl", str(tmp_path))
    out = t5.tokenize(["the cat sat", "cat"])
    assert out["input_ids"].shape == out["attention_mask"].shape == (2, 120)
    assert out["attention_mask"].sum(1).tolist() == [4, 2]
    for name in ("openclip:hf-hub:apple/DFN5B-CLIP-ViT-H-14-378", "DeepFloyd/t5-v1_1-xxl"):
        with pytest.raises(FileNotFoundError):
            tte.UniversalTokenizer(name).tokenize(["a cat"])
        with pytest.raises(FileNotFoundError):
            tte.UniversalTokenizer(name, str(tmp_path / "empty")).tokenize(["a cat"])


PIECES = [("<pad>", 0.0, jspm.TYPE_CONTROL), ("</s>", 0.0, jspm.TYPE_CONTROL),
          ("<unk>", 0.0, jspm.TYPE_UNKNOWN), ("▁", -4.0, jspm.TYPE_NORMAL),
          ("▁the", -1.0, jspm.TYPE_NORMAL), ("▁cat", -1.5, jspm.TYPE_NORMAL),
          ("▁ca", -3.0, jspm.TYPE_NORMAL), ("t", -2.0, jspm.TYPE_NORMAL),
          ("c", -3.5, jspm.TYPE_NORMAL), ("a", -3.5, jspm.TYPE_NORMAL),
          ("▁sat", -1.7, jspm.TYPE_NORMAL), ("s", -3.0, jspm.TYPE_NORMAL)]


def test_spm_copy_matches_jax(tmp_path):
    """The port's utils/spm.py against the JAX package's on tests/test_spm.py's
    piece table: proto round trip, segmentation, the T5 tokenizer's output."""
    data = jspm.build_model_proto(PIECES)
    assert tspm.build_model_proto(PIECES) == data
    assert tspm.read_model_proto(data) == jspm.read_model_proto(data)
    texts = ["the cat sat", "cat!", "  the \t cat ", "catsat ca t", "Ünïcode ｆｕｌｌ"]
    j, t = jspm.SentencePieceUnigram(list(PIECES)), tspm.SentencePieceUnigram(list(PIECES))
    for text in texts:
        assert t.encode(text) == j.encode(text)
    path = tmp_path / "spiece.model"
    path.write_bytes(data)
    jo = jspm.T5SpmTokenizer(str(path))(texts, max_length=6)
    to = tspm.T5SpmTokenizer(str(path))(texts, max_length=6)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(to[key], jo[key])


# -------------------------------------------------------------- weight readers


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=g), "bf16": torch.randn(7, generator=g).bfloat16(),
        "f16": torch.randn(2, 2, 2, generator=g).half(), "i64": torch.arange(6).reshape(2, 3),
        "i32": torch.arange(5, dtype=torch.int32), "u8": torch.arange(9, dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]), "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
    }
    path = str(tmp_path / "w.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = tte.read_safetensors(path)
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and torch.equal(got[k], v), k
    assert tte.load_state_dict_from_dir(str(tmp_path)).keys() == tensors.keys()
    torch.save({"a": torch.ones(2)}, str(tmp_path / "extra.bin"))  # safetensors win
    assert "a" not in tte.load_state_dict_from_dir(str(tmp_path))
    os.remove(path)
    assert torch.equal(tte.load_state_dict_from_dir(str(tmp_path))["a"], torch.ones(2))
    os.remove(str(tmp_path / "extra.bin"))
    with pytest.raises(FileNotFoundError):
        tte.load_state_dict_from_dir(str(tmp_path))
