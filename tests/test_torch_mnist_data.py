"""The port's procedural MNIST against the reference: ``make_dataset`` gives
the same images and labels byte for byte, and ``batches`` the same batches
in the same order, for every (n, seed) tried (the system tests' training and
test sets among them)."""
import itertools

import numpy as np
import pytest

from repro.data import mnist as j_mnist

from repro_torch.data import mnist as t_mnist

SIZES = [(1024, 0), (256, 99), (512, 99), (64, 0), (1, 7), (33, 123)]


@pytest.mark.parametrize("n,seed", SIZES)
def test_make_dataset_equals_the_reference_byte_for_byte(n, seed):
    imgs, labels = t_mnist.make_dataset(n, seed=seed)
    j_imgs, j_labels = j_mnist.make_dataset(n, seed=seed)
    assert imgs.shape == (n, 28, 28, 1) and imgs.dtype == np.float32
    assert labels.shape == (n,) and labels.dtype == np.int32
    assert imgs.tobytes() == j_imgs.tobytes()
    assert labels.tobytes() == j_labels.tobytes()
    assert imgs.min() >= 0.0 and imgs.max() <= 1.0


@pytest.mark.parametrize("batch_size,seed", [(64, 0), (7, 3), (33, 99)])
def test_batches_equal_the_reference(batch_size, seed):
    """The first batches, across an epoch boundary (100 rows hold at most 14
    batches of 7), in the reference's order."""
    imgs, labels = t_mnist.make_dataset(100, seed=5)
    got = itertools.islice(t_mnist.batches(imgs, labels, batch_size, seed), 20)
    want = itertools.islice(j_mnist.batches(imgs, labels, batch_size, seed),
                            20)
    for (x, y), (jx, jy) in zip(got, want):
        assert x.shape == (batch_size, 28, 28, 1)
        assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()


def test_seeds_give_other_images():
    a, la = t_mnist.make_dataset(16, seed=0)
    b, lb = t_mnist.make_dataset(16, seed=1)
    assert not np.array_equal(a, b)
    assert set(np.unique(t_mnist.make_dataset(256, seed=0)[1])) == set(range(10))
