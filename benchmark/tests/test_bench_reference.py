"""The plain reference on a tiny scene on the CPU: it computes the
program's function (renderer, tower), and the program's run of the
harness reads correct against it; the control does not."""
import json

import numpy as np
import pytest
import torch

from benchmark import check, harness
from benchmark.reference import clip as ref_clip
from benchmark.reference import render
from benchmark.weights import make_weights


@pytest.fixture(scope="module")
def tiny_run(tiny_root):
    torch.set_num_threads(4)
    return harness.run("tiny", 2**31 + 5, 0.0, False, "cpu", workers=2,
                       root=tiny_root)


def test_renderer_matches_the_programs():
    from vilgod_tpu_torch.ops.rasterize import render_cluster_views
    gen = torch.Generator().manual_seed(3)
    for n in (40, 2400):
        pts = (torch.rand(n, 3, generator=gen) * torch.tensor([4.4, 1.9, 1.6])
               + torch.tensor([12.0, -4.0, -1.7]))
        ours = render.views(pts)
        theirs = render_cluster_views(pts[None], torch.ones(1, n, dtype=bool))
        assert (ours - theirs[0]).abs().max() < 1e-4


def test_tower_matches_the_programs_in_float32(tiny_root):
    from vilgod_tpu_torch.models.clip import CLIPConfig, CLIPModel
    tower = json.loads((tiny_root / "configs" / "tiny.json").read_text())[
        "clip"]
    w = make_weights(tower, 11, "cpu")
    model = CLIPModel(CLIPConfig(**{k: v for k, v in tower.items()
                                    if k != "dtype"}))
    model.load_state_dict(w)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 224, 224, 3, generator=gen)
    ours = ref_clip.encode_image(w, x.permute(0, 3, 1, 2), tower)
    np.testing.assert_allclose(ours, model.encode_image(x), atol=2e-4)
    tokens = torch.from_numpy(ref_clip.tokenize(["a point representation "
                                                 "of a car"], 49408, 77))
    np.testing.assert_allclose(ref_clip.encode_text(w, tokens, tower),
                               model.encode_text(tokens), atol=2e-4)


def test_the_program_reads_correct(tiny_run):
    values = check.readings(tiny_run["rec"].sequences, tiny_run["seqs"],
                            tiny_run["config"], 2**31 + 5,
                            torch.device("cpu"))
    ok, table = check.judge(values, tiny_run["limits"])
    assert ok, table
    assert tiny_run["rec"].sequences[0]["sample"]


@pytest.mark.parametrize("control", [True, "operands"])
def test_the_control_reads_incorrect(tiny_run, control):
    values = check.readings(tiny_run["rec"].sequences, tiny_run["seqs"],
                            tiny_run["config"], 2**31 + 5,
                            torch.device("cpu"), control=control)
    ok, table = check.judge(values, tiny_run["limits"])
    assert not ok, table


def test_draws_match_the_programs():
    from vilgod_tpu_torch.ops import random as jrandom
    from benchmark.reference import threefry
    seed = 2**40 + 666
    ours = threefry.fold_in(threefry.fold_in(threefry.key(seed), 17), 1)
    theirs = jrandom.fold_in(jrandom.fold_in(jrandom.PRNGKey(seed), 17), 1)
    assert ours == theirs
    assert threefry.split(ours) == jrandom.split(theirs)
    np.testing.assert_array_equal(
        threefry.unit_floats(ours, 5000, "cpu").clamp(min=0.0),
        jrandom.uniform(theirs, 5000))
    np.testing.assert_allclose(threefry.gumbel(ours, 3, 5000, "cpu"),
                               jrandom.gumbel(theirs, (3, 5000)), rtol=2e-6,
                               atol=1e-6)
