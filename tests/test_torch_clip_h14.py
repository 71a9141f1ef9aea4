"""DFN5B CLIP ViT-H/14-378 in the port, on the CPU.

A tiny tower at the new shape's token count and head width (378 px, patch
14: 730 tokens; width 160 of 2 heads of 80, 2 layers; text width 128)
built through the port's ``CLIPModel`` from ``benchmark/weights.py``'s
seeded weights, against the benchmark's plain float32 reference
(``benchmark/reference/clip.py``): image and text features. Its attention
halves take kernel 5's wrapper (heads of 80 pass the switch) and count the
streaming core, the one they take on the card. The preset and the table of
checkpoint names give the published sizes, which the benchmark's
configuration holds; the classification stage renders at 378 px;
``convert_openai_checkpoint`` maps open_clip's names (OpenAI's) onto the
port's modules; ``vit_stream_attn_roofline`` reads the streaming core
alone."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.flops import attention_half_bound_s
from benchmark.flops_long import core_bound_s
from benchmark.metrics import read
from benchmark.reference import clip as ref_clip
from benchmark.weights import make_weights
from test_torch_clip_l14 import _openai_state_dict, _state
from vilgod_tpu_torch.config import waymo_config
from vilgod_tpu_torch.models import clip as C
from vilgod_tpu_torch.models import vit_kernels as VK
from vilgod_tpu_torch.models.clip_wrapper import ClipWrapper
from vilgod_tpu_torch.utils import trace

TINY = dict(image_size=378, patch_size=14, vision_width=160, vision_layers=2,
            vision_heads=2, embed_dim=64, context_length=77,
            vocab_size=49408, text_width=128, text_heads=2, text_layers=2)
SEED = 3230000023
NAME = "DFN5B-CLIP-ViT-H-14-378.bin"
CONFIG = Path(__file__).resolve().parents[1] / "benchmark" / "configs" / \
    "waymo-vith14-378.json"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(dtype, seed=SEED):
    model = C.CLIPModel(C.CLIPConfig(**TINY, dtype=dtype))
    model.load_state_dict(make_weights(TINY, seed, "cpu"))
    return model


def _images(n=3, seed=0):
    """Depth-image-like inputs: CLIP-normalised grey images (B, S, S, 3)."""
    rng = np.random.default_rng(seed)
    grey = torch.from_numpy(rng.random((n, 378, 378)).astype(np.float32))
    return C.normalize_images(grey[..., None].expand(-1, -1, -1, 3))


def _cosine(a, b):
    a, b = a.double(), b.double()
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_tiny_730_token_tower_matches_the_reference(dt):
    """f32: the same function as the reference within 1e-4 (summation
    order only). bf16: the port rounds its activations to bf16 (a relative
    step of 2^-8) at every rounding point of its blocks, here over 730
    tokens and heads of 80, so its features carry an error of a few such
    steps (three seeds read a cosine of 0.99992 or more and at most 1.40 %
    of the features' largest magnitude): held at a cosine of 0.9995 with
    the reference's and 3 % of that magnitude, as at 577 tokens."""
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    assert VK.use_fused_attention(torch.bfloat16, 160, 2)
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
    assert model.visual.positional_embedding.shape == (730, 160)
    assert got_img.shape == (3, 64) and got_txt.shape == (2, 64)
    if dt == "f32":
        torch.testing.assert_close(got_img, want_img, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(got_txt, want_txt, atol=1e-4, rtol=1e-4)
    else:
        for got, want in ((got_img, want_img), (got_txt, want_txt)):
            assert float(_cosine(got, want).min()) >= 0.9995
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 0.03 * scale


def test_each_image_call_counts_the_stream_core_a_layer():
    """``attn_core.stream``: one a layer and call of each attention half
    at heads of 80 (the core the card takes), none of the others; on the
    CPU no launch."""
    model = _port(torch.bfloat16)
    VK.reset_launches()
    with trace.recording() as t, torch.no_grad():
        model.encode_image(_images(n=2))
        model.encode_image(_images(n=1, seed=1))
    assert t.total("attn_core.stream") == 2 * 2
    assert t.total("attn_core.long") == t.total("attn_core.onepass") == 0
    assert VK.CORE_LAUNCHES == {"onepass": 0, "long": 0, "stream": 0}
    assert VK.attention_core_kind(730, 80) == "stream"
    assert VK.attention_core_kind(577, 64) == "long"


def test_preset_table_and_configuration_give_the_published_sizes():
    h14 = C.clip_vit_h14_378(torch.bfloat16)
    assert (h14.image_size, h14.patch_size, h14.vision_width,
            h14.vision_layers, h14.vision_heads) == (378, 14, 1280, 32, 16)
    assert (h14.image_size // h14.patch_size) ** 2 + 1 == 730
    assert h14.vision_width // h14.vision_heads == 80
    assert (h14.embed_dim, h14.context_length, h14.vocab_size,
            h14.text_width, h14.text_heads, h14.text_layers) == (
        1024, 77, 49408, 1024, 16, 24)
    assert h14.dtype == torch.bfloat16
    assert C.clip_config_for(NAME) == C.clip_vit_h14_378()
    assert C.clip_config_for(f"/ckpt/{NAME}", torch.bfloat16) == h14
    assert C.CHECKPOINTS[NAME] is C.clip_vit_h14_378
    assert VK.use_fused_attention(torch.bfloat16, 1280, 16)
    # the benchmark's configuration runs the preset as published
    config = json.loads(CONFIG.read_text())
    tower = config["clip"]
    assert tower.pop("dtype") == "bfloat16"
    assert C.CLIPConfig(**tower, dtype=torch.bfloat16) == h14
    assert config["projection"]["image_size"] == 378


def test_stage_renders_at_378():
    from vilgod_tpu_torch.pipeline.stages_classify import classification

    cfg = waymo_config()
    clip = ClipWrapper(cfg["preprocessor"]["clip"], device="cpu",
                       model_cfg=C.CLIPConfig(**TINY, dtype=torch.float32))
    seen = []
    encode = clip.model.encode_image
    clip.model.encode_image = lambda x: seen.append(tuple(x.shape)) or encode(x)
    state = _state()
    classification(state, cfg, clip_model=clip)
    assert seen == [(4 * 8, 378, 378, 3)]          # 8 items, 4 views each
    assert (state.det_cls[state.det_valid] >= 0).all()
    assert clip.render_size() == 378
    with pytest.raises(ValueError, match="336.*378"):
        classification(_state(), cfg, clip_model=clip, image_size=336)


def test_convert_checkpoint_maps_open_clip_names(tmp_path, monkeypatch):
    """open_clip's DFN5B state dict keeps OpenAI's names and layouts: saved
    under the table's name (a tiny stand-in there), the converter and the
    wrapper take the tower from the name and put every weight where the
    port's modules keep it."""
    cfg = C.CLIPConfig(**TINY)
    sd = _openai_state_dict(cfg)
    path = tmp_path / NAME
    torch.save(sd, path)
    monkeypatch.setitem(C.CHECKPOINTS, NAME,
                        lambda dtype=torch.float32: C.CLIPConfig(**TINY,
                                                                 dtype=dtype))
    model = C.convert_openai_checkpoint(str(path), device="cpu")
    assert model.cfg == cfg
    v = model.visual
    assert v.positional_embedding.shape == (730, 160)
    pre = "visual.transformer.resblocks.1"
    blk = v.transformer.block_1
    assert torch.equal(blk.attn.qkv.kernel, sd[f"{pre}.attn.in_proj_weight"].T)
    assert torch.equal(blk.mlp_proj.kernel, sd[f"{pre}.mlp.c_proj.weight"].T)
    assert torch.equal(v.patch_embed.kernel,
                       sd["visual.conv1.weight"].permute(2, 3, 1, 0))
    assert torch.equal(model.text.text_projection, sd["text_projection"])
    wrapper = ClipWrapper(waymo_config()["preprocessor"]["clip"],
                          device="cpu", checkpoint_path=str(path))
    assert wrapper.model_cfg == C.CLIPConfig(**TINY, dtype=torch.bfloat16)
    assert wrapper.render_size() == 378
    with torch.no_grad():
        feats = model.encode_image(_images(n=1))
    assert feats.shape == (1, 64) and torch.isfinite(feats).all()


H100 = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
H14 = dict(image_size=378, patch_size=14, vision_width=1280, vision_layers=32)
L14 = dict(image_size=336, patch_size=14, vision_width=1024, vision_layers=24)
STREAM = ("void (anonymous namespace)::attention_stream_kernel<80>("
          "__nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int, float)")
LONG = ("void (anonymous namespace)::attention_kernel<19>(__nv_bfloat16 "
        "const*, __nv_bfloat16*, int, int, int, float)")


def _ctx(tower, device_ops, bound):
    return {"trace": {"attention_half_bound_s": bound,
                      "device_ops": device_ops},
            "peak": H100, "tower": tower}


def test_stream_roofline_reads_the_stream_core_alone():
    """``vit_stream_attn_roofline`` on made-up traces: the least time of
    the (image, layer) pairs behind the traced halves over the streaming
    core's device time; nothing without its launches, and the long core's
    reader does not take its kernel."""
    images = 2 * 3 * 4 + 4 * 512 * 4
    bound = sum(32 * attention_half_bound_s(n, 730, 1280, H100)
                for n in (2 * 3 * 4, 4 * 512 * 4))
    least = 32 * images * core_bound_s(730, 1280, H100)
    assert core_bound_s(730, 1280, H100) == pytest.approx(2.758e-6, rel=1e-3)
    ops = {STREAM[:120]: 4 * least, LONG[:120]: 5.0, "nvjet_tst": 9.0}
    assert read("vit_stream_attn_roofline", _ctx(H14, ops, bound)) == \
        pytest.approx(25.0)
    assert read("vit_stream_attn_roofline", _ctx(
        H14, {LONG[:120]: 1.0}, bound)) is None
    assert read("vit_stream_attn_roofline", {"trace": None, "peak": H100,
                                             "tower": H14}) is None
    assert read("vit_long_attn_roofline", _ctx(
        H14, {STREAM[:120]: 1.0}, bound)) is None
    l14 = 24 * attention_half_bound_s(2048, 577, 1024, H100)
    assert read("vit_stream_attn_roofline", _ctx(
        L14, {LONG[:120]: 1.0}, l14)) is None
