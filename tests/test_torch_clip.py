"""The port's CLIP (vilgod_tpu_torch/models/clip.py, tokenizer.py,
clip_wrapper.py) against vilgod_tpu/models: the same JAX parameter tree
carried across with params_from_jax gives the same image and text
embeddings (f32 within 1e-4); a bf16 tower whose attention halves take the
fused kernel's plain version stays within the fused-vs-unfused tolerance
of tests/test_clip.py; the tokenizers give the same ids; and the OpenAI
checkpoint converters agree on the same file."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vilgod_tpu.config.presets import waymo_config as jax_waymo_config
from vilgod_tpu.models import clip as CJ
from vilgod_tpu.models.clip_wrapper import ClipWrapper as JaxClipWrapper
from vilgod_tpu.models.tokenizer import ClipTokenizer as JaxClipTokenizer
from vilgod_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from vilgod_tpu_torch.models import clip as CT
from vilgod_tpu_torch.models.clip_wrapper import ClipWrapper
from vilgod_tpu_torch.models.tokenizer import ClipTokenizer, HashTokenizer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_classification.py's SMALL_CLIP
SMALL = dict(image_size=224, patch_size=32, vision_width=64, vision_layers=2,
             vision_heads=2, embed_dim=32, context_length=77,
             vocab_size=49408, text_width=32, text_heads=2, text_layers=2)


def _pair(kw, jdt, tdt, seed=0):
    jc = CJ.CLIPConfig(**kw, dtype=jdt)
    params = CJ.init_clip_params(jc, seed=seed)
    tc = CT.CLIPConfig(**kw, dtype=tdt)
    return jc, params, CT.params_from_jax(jax.tree.map(np.asarray, params), tc,
                                            device="cpu")


def _tokens():
    return JaxHashTokenizer().tokenize(["a point representation of a car",
                                        "a point representation of a tree",
                                        "pedestrian"])


def test_params_from_jax_f32_embeddings():
    jc, params, model = _pair(SMALL, jnp.float32, torch.float32)
    jm = CJ.CLIPModel(jc)
    images = np.random.default_rng(0).normal(
        size=(3, 224, 224, 3)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(images),
                               method=jm.encode_image))
    got = model.encode_image(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    tokens = _tokens()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens),
                               method=jm.encode_text))
    got = model.encode_text(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_wrapper_text_features_match_jax():
    """ClipWrapper's normalised prompt features, from the same weights."""
    clip_cfg = jax_waymo_config()["preprocessor"]["clip"]
    jw = JaxClipWrapper(clip_cfg, model_cfg=CJ.CLIPConfig(**SMALL))
    tc = CT.CLIPConfig(**SMALL)
    tw = ClipWrapper(clip_cfg, model_cfg=tc, device="cpu",
                     model=CT.params_from_jax(
                         jax.tree.map(np.asarray, jw.params), tc, device="cpu"))
    assert tw.text_features.shape == (24, 32)
    np.testing.assert_allclose(tw.text_features.numpy(),
                               np.asarray(jw.text_features), atol=1e-4,
                               rtol=0)


def test_bf16_tower_with_fused_attention_matches_jax():
    """Width 128 over 2 heads: the port's bf16 tower takes the fused
    attention's plain version (the card's kernel arithmetic), JAX's CPU
    tower its unfused path; tolerance of tests/test_clip.py:509-511."""
    kw = dict(SMALL, image_size=64, patch_size=16, vision_width=128,
              embed_dim=64)
    jc, params, model = _pair(kw, jnp.bfloat16, torch.bfloat16, seed=3)
    assert CT.VK.use_fused_attention(torch.bfloat16, 128, 2)
    images = (np.random.default_rng(1).normal(size=(2, 64, 64, 3)) * 0.4
              ).astype(np.float32)
    jm = CJ.CLIPModel(jc)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(images),
                               method=jm.encode_image), np.float32)
    CT.VK.reset_launches()
    got = model.encode_image(torch.from_numpy(images)).float().numpy()
    assert CT.VK.LAUNCHES["fused_attention_proj"] == 0   # CPU: plain version
    scale = np.abs(want).mean()
    assert np.mean(np.abs(got - want)) < 0.05 * scale + 1e-4
    np.testing.assert_allclose(got, want, rtol=0.5, atol=0.3 * scale)


def test_hash_tokenizer_ids_equal():
    texts = ["a point representation of a pickup truck", "Tree  ", "bike"]
    for kw in ({}, {"vocab_size": 128, "context_length": 16}):
        np.testing.assert_array_equal(HashTokenizer(**kw).tokenize(texts),
                                      JaxHashTokenizer(**kw).tokenize(texts))


def test_bpe_tokenizer_ids_equal(tmp_path):
    """A tiny merge table in the checkpoint's format: both BPE tokenizers
    give the same ids (the real table is not in the repository)."""
    import gzip
    merges = ["#version: 0.2", "p o", "po i", "poi n", "t </w>", "poin t</w>",
              "c a", "ca r</w>", "t r", "tr e", "tre e</w>"]
    path = tmp_path / "bpe.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(merges) + "\n")
    texts = ["a point representation of a car", "tree  point", "Car!"]
    np.testing.assert_array_equal(ClipTokenizer(path).tokenize(texts),
                                  JaxClipTokenizer(path).tokenize(texts))


def _openai_state_dict(tree, cfg):
    """The OpenAI checkpoint's names and layouts, made from a flax tree
    (the inverse of the converters' mapping)."""
    sd = {}
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731

    def block(prefix, b):
        sd[f"{prefix}.ln_1.weight"] = t(b["ln_1"]["scale"])
        sd[f"{prefix}.ln_1.bias"] = t(b["ln_1"]["bias"])
        sd[f"{prefix}.ln_2.weight"] = t(b["ln_2"]["scale"])
        sd[f"{prefix}.ln_2.bias"] = t(b["ln_2"]["bias"])
        sd[f"{prefix}.attn.in_proj_weight"] = t(b["attn"]["qkv"]["kernel"]).T
        sd[f"{prefix}.attn.in_proj_bias"] = t(b["attn"]["qkv"]["bias"])
        sd[f"{prefix}.attn.out_proj.weight"] = t(b["attn"]["out"]["kernel"]).T
        sd[f"{prefix}.attn.out_proj.bias"] = t(b["attn"]["out"]["bias"])
        sd[f"{prefix}.mlp.c_fc.weight"] = t(b["mlp_fc"]["kernel"]).T
        sd[f"{prefix}.mlp.c_fc.bias"] = t(b["mlp_fc"]["bias"])
        sd[f"{prefix}.mlp.c_proj.weight"] = t(b["mlp_proj"]["kernel"]).T
        sd[f"{prefix}.mlp.c_proj.bias"] = t(b["mlp_proj"]["bias"])

    v, x = tree["visual"], tree["text"]
    sd["visual.conv1.weight"] = t(v["patch_embed"]["kernel"]).permute(3, 2, 0, 1)
    for k in ("class_embedding", "positional_embedding", "proj"):
        sd[f"visual.{k}"] = t(v[k])
    for k in ("ln_pre", "ln_post"):
        sd[f"visual.{k}.weight"] = t(v[k]["scale"])
        sd[f"visual.{k}.bias"] = t(v[k]["bias"])
    for i in range(cfg.vision_layers):
        block(f"visual.transformer.resblocks.{i}", v["transformer"][f"block_{i}"])
    sd["token_embedding.weight"] = t(x["token_embedding"])
    sd["positional_embedding"] = t(x["positional_embedding"])
    sd["text_projection"] = t(x["text_projection"])
    sd["ln_final.weight"] = t(x["ln_final"]["scale"])
    sd["ln_final.bias"] = t(x["ln_final"]["bias"])
    for i in range(cfg.text_layers):
        block(f"transformer.resblocks.{i}", x["transformer"][f"block_{i}"])
    sd["logit_scale"] = t(tree["logit_scale"])
    return sd


def test_convert_openai_checkpoint_matches_jax(tmp_path):
    """Both converters read the same state_dict file into the same model
    (the real ViT-B-16.pt waits until the repository has one)."""
    jc, params, _ = _pair(SMALL, jnp.float32, torch.float32, seed=5)
    path = tmp_path / "clip.pt"
    torch.save(_openai_state_dict(jax.tree.map(np.asarray, params), jc), path)
    jparams = CJ.convert_openai_checkpoint(str(path), jc)
    model = CT.convert_openai_checkpoint(str(path), CT.CLIPConfig(**SMALL),
                                         device="cpu")
    images = np.random.default_rng(2).normal(
        size=(2, 224, 224, 3)).astype(np.float32)
    jm = CJ.CLIPModel(jc)
    want = np.asarray(jm.apply({"params": jparams}, jnp.asarray(images),
                               method=jm.encode_image))
    np.testing.assert_allclose(
        model.encode_image(torch.from_numpy(images)).numpy(), want,
        atol=1e-4, rtol=1e-4)
    tokens = _tokens()
    want = np.asarray(jm.apply({"params": jparams}, jnp.asarray(tokens),
                               method=jm.encode_text))
    np.testing.assert_allclose(
        model.encode_text(torch.from_numpy(tokens).long()).numpy(), want,
        atol=1e-4, rtol=1e-4)


def test_init_clip_params_is_seeded():
    """Random weights come from an explicit generator: the same seed gives
    the same model, another seed another one."""
    cfg = CT.CLIPConfig(**dict(SMALL, vocab_size=512))
    a, b, c = (CT.init_clip_params(cfg, seed=s, device="cpu")
               for s in (0, 0, 1))
    wa = a.visual.transformer.block_0.attn.qkv.kernel
    assert torch.equal(wa, b.visual.transformer.block_0.attn.qkv.kernel)
    assert not torch.equal(wa, c.visual.transformer.block_0.attn.qkv.kernel)
    # LeCun-normal: std ~ 1/sqrt(fan_in), truncated at 2 std
    assert abs(float(wa.std()) * np.sqrt(64) - 1.0) < 0.1
    assert float(wa.abs().max()) * np.sqrt(64) <= 2 / 0.87962566103423978
