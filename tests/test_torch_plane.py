"""The port's RANSAC top-3 (vilgod_tpu_torch/ops/plane.py ``top3_first``)
against ``jax.lax.top_k``: the same indices in the same order, the lower
index first among equal values, on JAX-drawn Gumbel rows (whose 23 random
bits make the top of a 131072-wide row tie often), on crafted ties and on
masks with fewer than three valid points (-inf ties). Then one
``ransac_plane`` call whose best row is a tie row, against JAX's."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vilgod_tpu.ops import plane as JP
from vilgod_tpu_torch.ops import plane as TP

N = 131072
# key (1, 7), row 86: JAX's triple; torch.topk's third index is 39015,
# which ties with 3654
ROW86 = [35023, 120537, 3654]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(s):
    return jnp.asarray([s, 7], dtype=jnp.uint32)


def _jax_top3(scores):
    return np.asarray(jax.lax.top_k(jnp.asarray(scores), 3)[1])


def _port_top3(scores):
    return TP.top3_first(torch.from_numpy(np.ascontiguousarray(scores))).numpy()


@pytest.mark.parametrize("s", range(5))
def test_top3_equals_jax_on_gumbel_rows(s):
    """All 100 rows of a RANSAC stage's draw for key (s, 7), fed as the
    same numpy array to both; key (1, 7) holds the tie rows 42 and 86."""
    g = np.array(jax.random.gumbel(_key(s), (100, N)))
    want = _jax_top3(g)
    np.testing.assert_array_equal(_port_top3(g), want)
    if s == 1:
        ranked = np.sort(g, axis=1)[:, ::-1]
        # rows where two of the top four scores are equal
        ties = np.flatnonzero((ranked[:, :3] == ranked[:, 1:4]).any(axis=1))
        assert {42, 86} <= set(ties.tolist())
        assert want[86].tolist() == ROW86


def test_top3_crafted_ties():
    """Rows drawn from a few values, so that every rank ties many ways;
    negative, positive, zero and -inf scores."""
    rng = np.random.default_rng(0)
    vals = np.asarray([-np.inf, -2.5, -1.0, 0.0, 0.75, 3.0], np.float32)
    scores = vals[rng.integers(0, vals.size, (64, 257))]
    scores[0] = 1.0                       # one value throughout
    scores[1] = -np.inf
    scores[2, :] = -1.0
    scores[2, [200, 5]] = -0.5            # two leaders, out of index order
    np.testing.assert_array_equal(_port_top3(scores), _jax_top3(scores))
    assert _port_top3(scores)[0].tolist() == [0, 1, 2]
    assert _port_top3(scores)[2].tolist() == [5, 200, 0]


@pytest.mark.parametrize("n_valid", [0, 1, 2, 3])
def test_top3_masks_with_few_valid_points(n_valid):
    """The RANSAC logits of a mask with fewer than three valid points: the
    rest of each triple is the lowest -inf indices, as in JAX."""
    rng = np.random.default_rng(n_valid)
    mask = np.zeros(4096, bool)
    mask[rng.choice(4096, n_valid, replace=False)] = True
    g = np.array(jax.random.gumbel(_key(n_valid), (100, 4096)))
    scores = np.where(mask, np.float32(0.0), np.float32(-np.inf)) + g
    want = _jax_top3(scores)
    np.testing.assert_array_equal(_port_top3(scores), want)
    assert (mask[want[:, :n_valid]]).all()


def test_ransac_plane_on_a_tie_row_matches_jax():
    """A 131072-point cloud in a tall box, with 2000 points on one plane
    that include key (1, 7) row 86's triple but not 39015: only that row
    draws three points of the plane, so it is the best row exactly when
    the tie at its third rank goes to the lower index."""
    rng = np.random.default_rng(21)
    pts = np.column_stack([rng.uniform(-50, 50, (N, 2)),
                           rng.uniform(-500, 500, N)]).astype(np.float32)
    on = rng.choice(N, 2000, replace=False)
    on = np.union1d(np.setdiff1d(on, [39015]), ROW86)
    pts[on, 2] = 0.1 * pts[on, 0] + 0.05 * pts[on, 1] + 2.0
    mask = np.ones(N, bool)
    pj, ij = JP.ransac_plane(jnp.asarray(pts), jnp.asarray(mask), _key(1))
    pt, it = TP.ransac_plane(torch.from_numpy(pts), torch.from_numpy(mask),
                             (1, 7))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # JAX's best row is the plane row: its inliers hold the whole plane
    assert np.asarray(ij)[on].all()
