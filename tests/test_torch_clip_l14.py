"""CLIP ViT-L/14@336px in the port, on the CPU.

A tiny tower at the new shape's token count (336 px, patch 14: 577
tokens; width 128, 2 heads of 64, 2 layers; text width 128) built through
the port's ``CLIPModel`` from ``benchmark/weights.py``'s seeded weights,
against the benchmark's plain float32 reference (``benchmark/reference/
clip.py``): image and text features. The classification stage renders at
the tower's size and refuses another; the presets and the table of
OpenAI checkpoint names give the published sizes; ``convert_openai_
checkpoint`` maps OpenAI's L/14@336 key names onto the port's modules."""
import numpy as np
import pytest
import torch

from benchmark.reference import clip as ref_clip
from benchmark.weights import make_weights
from vilgod_tpu_torch.config import waymo_config
from vilgod_tpu_torch.models import clip as C
from vilgod_tpu_torch.models.clip_wrapper import ClipWrapper
from vilgod_tpu_torch.utils import trace

TINY = dict(image_size=336, patch_size=14, vision_width=128, vision_layers=2,
            vision_heads=2, embed_dim=64, context_length=77,
            vocab_size=49408, text_width=128, text_heads=2, text_layers=2)
SEED = 3190000019


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(dtype, seed=SEED):
    cfg = C.CLIPConfig(**TINY, dtype=dtype)
    model = C.CLIPModel(cfg)
    model.load_state_dict(make_weights(TINY, seed, "cpu"))
    return model


def _images(n=3, seed=0):
    """Depth-image-like inputs: CLIP-normalised grey images (B, S, S, 3)."""
    rng = np.random.default_rng(seed)
    grey = torch.from_numpy(rng.random((n, 336, 336)).astype(np.float32))
    return C.normalize_images(grey[..., None].expand(-1, -1, -1, 3))


def _cosine(a, b):
    a, b = a.double(), b.double()
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_tiny_577_token_tower_matches_the_reference(dt):
    """f32: the same function as the reference within 1e-4 (summation
    order only). bf16: the port rounds its activations to bf16 (8 bits of
    mantissa, a relative step of 2^-8 = 0.4 %) at every rounding point of
    its blocks, so its features carry an error of a few such steps (three
    seeds read a cosine of 0.99996 or more and at most 1.07 % of the
    features' largest magnitude): held at a cosine of 0.9995 with the
    reference's and 3 % of that magnitude."""
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    model = _port(dtype)
    w = make_weights(TINY, SEED, "cpu")
    images = _images()
    tokens = torch.from_numpy(ref_clip.tokenize(
        ["a point representation of a car", "a point representation of a tree"],
        TINY["vocab_size"], TINY["context_length"]))
    with torch.no_grad():
        got_img = model.encode_image(images).float()
        got_txt = model.encode_text(tokens).float()
        want_img = ref_clip.encode_image(w, images.permute(0, 3, 1, 2), TINY)
        want_txt = ref_clip.encode_text(w, tokens, TINY)
    assert model.visual.positional_embedding.shape == (577, 128)
    assert got_img.shape == (3, 64) and got_txt.shape == (2, 64)
    if dt == "f32":
        torch.testing.assert_close(got_img, want_img, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(got_txt, want_txt, atol=1e-4, rtol=1e-4)
    else:
        for got, want in ((got_img, want_img), (got_txt, want_txt)):
            assert float(_cosine(got, want).min()) >= 0.9995
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 0.03 * scale


@pytest.mark.parametrize("mlp", ["fused", "composite"])
def test_bf16_tower_runs_its_mlp_half_through_kernel_10(mlp, monkeypatch):
    """Width 128 is 128-aligned, so by default each layer's MLP half of a
    bf16 tower takes ``fused_mlp_block`` (kernel 10; its plain version on
    the CPU, the card's rounding points) and counts ``mlp_half.fused``
    once a layer and image call; ``VILGOD_FUSED_MLP_BLOCK=0`` takes the
    unfused composite and counts none. Either way the image features hold
    to the plain float32 reference at the large towers' tolerance (cosine
    0.9995, 3 % of the largest magnitude), and no launch is counted."""
    from vilgod_tpu_torch.models import vit_kernels as VK

    if mlp == "composite":
        monkeypatch.setenv("VILGOD_FUSED_MLP_BLOCK", "0")
    model = _port(torch.bfloat16)
    w = make_weights(TINY, SEED, "cpu")
    images = _images(n=2, seed=4)
    VK.reset_launches()
    with trace.recording() as t, torch.no_grad():
        got = model.encode_image(images).float()
        model.encode_image(images[:1])
    want = ref_clip.encode_image(w, images.permute(0, 3, 1, 2), TINY)
    layers = TINY["vision_layers"]
    assert t.total("mlp_half.fused") == (2 * layers if mlp == "fused" else 0)
    assert t.total("attn_core.long") == 2 * layers
    assert VK.LAUNCHES["fused_mlp_block"] == 0
    assert float(_cosine(got, want).min()) >= 0.9995
    assert float((got - want).abs().max()) <= 0.03 * float(want.abs().max())


def _state(n_frames=2, n_clusters=4, cap=8):
    """The fields of a sequence state the classification stage reads: two
    valid detections of 8 points each."""
    import types

    valid = np.zeros((n_frames, n_clusters), bool)
    valid[0, :2] = True
    caps = types.SimpleNamespace(clip_batch=8, max_clusters=n_clusters,
                                 max_cluster_points=cap)
    rng = np.random.default_rng(1)
    xyz = torch.from_numpy(rng.normal(size=(n_frames, 32, 3))
                           .astype(np.float32))
    return types.SimpleNamespace(
        caps=caps, n_frames=n_frames, torch_device=torch.device("cpu"),
        det_valid=valid, det_n=valid.astype(np.int32) * cap,
        det_cls=np.full(valid.shape, -1, np.int32),
        det_score=np.zeros(valid.shape, np.float32), done={},
        ng_bucket=lambda: 32,
        device=lambda key, f_pad, n: xyz,
        det_tables=lambda f_pad, n: (
            torch.arange(n_clusters * cap, dtype=torch.int32)
            .reshape(1, n_clusters, cap).remainder(32)
            .expand(f_pad, -1, -1).contiguous(),
            torch.ones((f_pad, n_clusters, cap), dtype=torch.bool)),
        transform_to_ego=lambda f: np.eye(4))


def test_stage_renders_at_the_towers_size_and_refuses_another():
    from vilgod_tpu_torch.pipeline.stages_classify import classification

    cfg = waymo_config()
    args = {p["name"]: p.get("args", {}) for p in cfg["pipeline"]}
    assert args["classification"]["image_size"] is None
    clip = ClipWrapper(cfg["preprocessor"]["clip"], device="cpu",
                       model_cfg=C.CLIPConfig(**TINY, dtype=torch.float32))
    seen = []
    encode = clip.model.encode_image
    clip.model.encode_image = lambda x: seen.append(tuple(x.shape)) or encode(x)
    state = _state()
    classification(state, cfg, clip_model=clip)
    assert seen == [(4 * 8, 336, 336, 3)]          # 8 items, 4 views each
    assert (state.det_cls[state.det_valid] >= 0).all()
    assert clip.render_size() == clip.render_size(336) == 336
    state = _state()
    with pytest.raises(ValueError, match="224.*336"):
        classification(state, cfg, clip_model=clip, image_size=224)
    with pytest.raises(ValueError, match="224.*336"):
        clip.make_cluster_classifier(num_clusters=4, capacity=8,
                                     image_size=224)


def test_presets_and_checkpoint_names_give_the_published_sizes(monkeypatch):
    l14 = C.clip_vit_l14_336(torch.bfloat16)
    assert (l14.image_size, l14.patch_size, l14.vision_width,
            l14.vision_layers, l14.vision_heads) == (336, 14, 1024, 24, 16)
    assert (l14.image_size // l14.patch_size) ** 2 + 1 == 577
    assert l14.vision_width // l14.vision_heads == 64
    assert (l14.embed_dim, l14.context_length, l14.vocab_size,
            l14.text_width, l14.text_heads, l14.text_layers) == (
        768, 77, 49408, 768, 12, 12)
    assert l14.dtype == torch.bfloat16
    assert C.clip_config_for("ViT-L-14-336px.pt") == C.clip_vit_l14_336()
    assert C.clip_config_for("/ckpt/ViT-B-16.pt", torch.bfloat16) == \
        C.clip_vit_b16(torch.bfloat16)
    assert set(C.CHECKPOINTS) == {"ViT-B-16.pt", "ViT-L-14-336px.pt",
                                  "DFN5B-CLIP-ViT-H-14-378.bin"}
    with pytest.raises(ValueError, match="ViT-B-32.pt"):
        C.clip_config_for("ViT-B-32.pt")
    # the wrapper takes its tower from the configuration's model_name: a
    # tiny stand-in under the L/14@336 name shows it consults the table
    monkeypatch.setitem(C.CHECKPOINTS, "ViT-L-14-336px.pt",
                        lambda dtype: C.CLIPConfig(**TINY, dtype=dtype))
    clip_cfg = dict(waymo_config()["preprocessor"]["clip"],
                    model_name="ViT-L-14-336px.pt")
    wrapper = ClipWrapper(clip_cfg, device="cpu")
    assert wrapper.model_cfg == C.CLIPConfig(**TINY, dtype=torch.bfloat16)
    assert wrapper.render_size() == 336
    assert C.clip_config_for(
        waymo_config()["preprocessor"]["clip"]["model_name"]) == C.clip_vit_b16()


def _openai_state_dict(cfg, seed=0):
    """A state dict under OpenAI CLIP's key names and layouts
    (clip/model.py), at ``cfg``'s widths."""
    gen = torch.Generator().manual_seed(seed)
    w, wt, e = cfg.vision_width, cfg.text_width, cfg.embed_dim
    p = cfg.patch_size
    n_tok = (cfg.image_size // p) ** 2 + 1

    def r(*shape):
        return torch.randn(*shape, generator=gen) * 0.02

    sd = {"visual.conv1.weight": r(w, 3, p, p),
          "visual.class_embedding": r(w),
          "visual.positional_embedding": r(n_tok, w),
          "visual.ln_pre.weight": 1 + r(w), "visual.ln_pre.bias": r(w),
          "visual.ln_post.weight": 1 + r(w), "visual.ln_post.bias": r(w),
          "visual.proj": r(w, e),
          "token_embedding.weight": r(cfg.vocab_size, wt),
          "positional_embedding": r(cfg.context_length, wt),
          "ln_final.weight": 1 + r(wt), "ln_final.bias": r(wt),
          "text_projection": r(wt, e), "logit_scale": torch.tensor(4.6052)}
    for prefix, width, layers in (("visual.transformer", w, cfg.vision_layers),
                                  ("transformer", wt, cfg.text_layers)):
        for i in range(layers):
            k = f"{prefix}.resblocks.{i}"
            sd.update({
                f"{k}.ln_1.weight": 1 + r(width), f"{k}.ln_1.bias": r(width),
                f"{k}.ln_2.weight": 1 + r(width), f"{k}.ln_2.bias": r(width),
                f"{k}.attn.in_proj_weight": r(3 * width, width),
                f"{k}.attn.in_proj_bias": r(3 * width),
                f"{k}.attn.out_proj.weight": r(width, width),
                f"{k}.attn.out_proj.bias": r(width),
                f"{k}.mlp.c_fc.weight": r(4 * width, width),
                f"{k}.mlp.c_fc.bias": r(4 * width),
                f"{k}.mlp.c_proj.weight": r(width, 4 * width),
                f"{k}.mlp.c_proj.bias": r(width)})
    return sd


def test_convert_openai_checkpoint_maps_l14_336_names(tmp_path, monkeypatch):
    """OpenAI's L/14@336 names and layouts at tiny widths, saved under the
    checkpoint's file name: the converter takes the tower from the table
    (a tiny stand-in under that name) and puts every weight where the
    port's modules keep it, transposed to the flax layout."""
    cfg = C.CLIPConfig(**TINY)
    sd = _openai_state_dict(cfg)
    path = tmp_path / "ViT-L-14-336px.pt"
    torch.save(sd, path)
    monkeypatch.setitem(C.CHECKPOINTS, "ViT-L-14-336px.pt",
                        lambda dtype=torch.float32: C.CLIPConfig(**TINY,
                                                                 dtype=dtype))
    model = C.convert_openai_checkpoint(str(path), device="cpu")
    assert model.cfg == cfg
    v, t = model.visual, model.text
    assert torch.equal(v.patch_embed.kernel,
                       sd["visual.conv1.weight"].permute(2, 3, 1, 0))
    assert torch.equal(v.positional_embedding,
                       sd["visual.positional_embedding"])
    assert v.positional_embedding.shape == (577, 128)
    assert torch.equal(v.proj, sd["visual.proj"])
    blk = v.transformer.block_1
    pre = "visual.transformer.resblocks.1"
    assert torch.equal(blk.attn.qkv.kernel, sd[f"{pre}.attn.in_proj_weight"].T)
    assert torch.equal(blk.attn.out.kernel,
                       sd[f"{pre}.attn.out_proj.weight"].T)
    assert torch.equal(blk.mlp_fc.kernel, sd[f"{pre}.mlp.c_fc.weight"].T)
    assert torch.equal(blk.mlp_proj.bias, sd[f"{pre}.mlp.c_proj.bias"])
    assert torch.equal(blk.ln_2.scale, sd[f"{pre}.ln_2.weight"])
    assert torch.equal(t.transformer.block_0.attn.qkv.bias,
                       sd["transformer.resblocks.0.attn.in_proj_bias"])
    assert torch.equal(t.token_embedding, sd["token_embedding.weight"])
    assert torch.equal(model.logit_scale, sd["logit_scale"])
    # and the converted tower runs at 336 px
    with torch.no_grad():
        feats = model.encode_image(_images(n=1))
    assert feats.shape == (1, 64) and torch.isfinite(feats).all()


def test_one_rule_chooses_the_tower(tmp_path, monkeypatch):
    """A checkpoint's file name decides the tower, over the configuration's
    ``model_name``, in the wrapper and in the converter alike; without a
    checkpoint ``model_name`` decides; a file that names no OpenAI tower
    needs its ``cfg``."""
    monkeypatch.setitem(C.CHECKPOINTS, "ViT-L-14-336px.pt",
                        lambda dtype=torch.float32: C.CLIPConfig(**TINY,
                                                                 dtype=dtype))
    tiny = C.CLIPConfig(**TINY, dtype=torch.bfloat16)
    clip_cfg = waymo_config()["preprocessor"]["clip"]
    assert clip_cfg["model_name"] == "ViT-B-16.pt"
    # a path that is not there: the tower by its name, random weights
    wrapper = ClipWrapper(clip_cfg, device="cpu",
                          checkpoint_path=str(tmp_path / "ViT-L-14-336px.pt"))
    assert wrapper.model_cfg == tiny
    assert wrapper.model.visual.positional_embedding.shape == (577, 128)
    # a checkpoint that is there goes through the converter with that tower
    path = tmp_path / "ViT-L-14-336px.pt"
    torch.save(_openai_state_dict(C.CLIPConfig(**TINY)), path)
    wrapper = ClipWrapper(clip_cfg, device="cpu", checkpoint_path=str(path))
    assert wrapper.model_cfg == tiny and wrapper.render_size() == 336
    other = tmp_path / "finetuned.pt"
    torch.save(_openai_state_dict(C.CLIPConfig(**TINY)), other)
    with pytest.raises(ValueError, match="finetuned.pt"):
        C.convert_openai_checkpoint(str(other), device="cpu")
    with pytest.raises(ValueError, match="finetuned.pt"):
        ClipWrapper(clip_cfg, device="cpu", checkpoint_path=str(other))
    model = C.convert_openai_checkpoint(str(other), C.CLIPConfig(**TINY),
                                        device="cpu")
    assert model.cfg == C.CLIPConfig(**TINY)
