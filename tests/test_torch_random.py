"""The port's threefry draws (vilgod_tpu_torch/ops/random.py) against
jax.random: keys and uniform floats must be bit-identical, for the key
chain the clustering subsample uses (PRNGKey(seed), fold_in(fnr),
fold_in(rel))."""
import numpy as np
import pytest
import torch
import jax

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
