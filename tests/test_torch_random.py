"""The port's threefry draws (vilgod_tpu_torch/ops/random.py) against
jax.random: keys, uniform and Gumbel floats must be bit-identical, for the
key chain the clustering subsample uses (PRNGKey(seed), fold_in(fnr),
fold_in(rel)) and the one the filter's RANSAC uses (fold_in(fnr), split,
gumbel((iters, n)))."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vilgod_tpu_torch.ops import random as R


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores: one intra-op
    thread per worker keeps torch's thread pools from oversubscribing them
    (eight threads per worker made these tests ten times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 666, 2 ** 31 - 1])
def test_keys_and_uniform_bit_identical(seed):
    kj, kt = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    assert tuple(np.asarray(kj).tolist()) == kt
    for fnr in (0, 7, 23):
        for rel in (0, 1):
            kj2 = jax.random.fold_in(jax.random.fold_in(kj, fnr), rel)
            kt2 = R.fold_in(R.fold_in(kt, fnr), rel)
            assert tuple(np.asarray(kj2).tolist()) == kt2
            for n in (4096, 8192, 40960):
                a = np.asarray(jax.random.uniform(kj2, (n,)))
                b = R.uniform(kt2, n).numpy()
                np.testing.assert_array_equal(a.view(np.uint32),
                                              b.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 666, 2 ** 31 - 1])
def test_split_and_gumbel_bit_identical(seed):
    """The RANSAC draws: split keys equal, Gumbel (100, n) floats equal bit
    for bit (the port's log is XLA's CPU log, not torch.log)."""
    for fnr in (0, 5):
        kj = jax.random.fold_in(jax.random.PRNGKey(seed), fnr)
        kt = R.fold_in(R.PRNGKey(seed), fnr)
        pair_j = jax.random.split(kj)
        pair_t = R.split(kt)
        assert [tuple(np.asarray(k).tolist()) for k in pair_j] == pair_t
        for kj2, kt2 in zip(pair_j, pair_t):
            for n in (1000, 8192):
                a = jax.random.gumbel(kj2, (100, n))
                b = R.gumbel(kt2, (100, n))
                np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))


def test_xla_log_bit_identical():
    """xla_log equals jnp.log bit for bit over uniform, tiny and huge
    positive floats (torch.log does not, in about one case in seven)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.random(200_000).astype(np.float32),
        np.exp(rng.uniform(-87, 88, 100_000)).astype(np.float32),
        np.float32([np.finfo(np.float32).tiny, 1.0, 2.0, 0.5, 1e-30]),
    ])
    x = x[x > 0]
    want = jax.jit(jnp.log)(x)
    np.testing.assert_array_equal(_bits(want),
                                  _bits(R.xla_log(torch.from_numpy(x)).numpy()))
