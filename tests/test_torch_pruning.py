"""The port's pruning: the three pruning tests of
``tests/test_roofline_pruning.py`` under the port's mapping, then the masks
of ``magnitude_prune``, ``nm_prune`` and ``prune_tree`` against the
reference's on the same numpy arrays, exactly, ties included (arrays drawn
from a handful of values, so equal magnitudes abound and the stable
argsort's order decides)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import pruning as j_pruning

from repro_torch.quant.pruning import (magnitude_prune, nm_prune, prune_tree,
                                       zero_weight_fraction)


def test_magnitude_prune_fraction():
    w = torch.arange(1.0, 101.0)
    p = magnitude_prune(w, 0.25)
    assert float(torch.mean((p == 0).to(torch.float32))) == 0.25
    # keeps the largest magnitudes
    assert float(p[-1]) == 100.0 and float(p[0]) == 0.0


def test_nm_prune_structure():
    w = torch.tensor([[1.0, -5.0, 0.1, 3.0, 2.0, -0.2, 4.0, 0.3]])
    p = nm_prune(w, n=2, m=4)
    assert float(torch.mean((p == 0).to(torch.float32))) == 0.5
    # each group of 4 keeps exactly its 2 largest |values|
    assert (p[0, :4] != 0).tolist() == [False, True, False, True]


def test_prune_tree_skips_norms():
    tree = {"a/w_up": torch.ones((8, 8)), "a/norm/w": torch.ones(8)}
    out, stats = prune_tree(tree, 0.5)
    assert torch.equal(out["a/norm/w"], torch.ones(8))
    assert 0.4 <= stats["zero_weight_frac"] <= 0.6


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "normal": rng.standard_normal((16, 24)).astype(np.float32),
        # few distinct magnitudes, both signs: ties everywhere
        "ties": (rng.integers(-3, 4, (12, 16)) * 0.5).astype(np.float32),
        "ones": np.ones((8, 8), np.float32),
        "3d": rng.integers(-2, 3, (2, 6, 8)).astype(np.float32),
    }


def _same(t: torch.Tensor, j) -> bool:
    j = np.asarray(j)
    return t.dtype == torch.float32 and np.array_equal(t.numpy(), j) and \
        np.array_equal(np.signbit(t.numpy()), np.signbit(j))


@pytest.mark.parametrize("name", sorted(_arrays()))
@pytest.mark.parametrize("sparsity", [0.0, 0.1, 0.25, 0.5, 0.9])
def test_magnitude_prune_equals_the_reference(name, sparsity):
    a = _arrays()[name]
    assert _same(magnitude_prune(torch.from_numpy(a), sparsity),
                 j_pruning.magnitude_prune(jnp.asarray(a), sparsity))


@pytest.mark.parametrize("name", sorted(_arrays()))
@pytest.mark.parametrize("n,m", [(2, 4), (1, 4), (3, 4), (1, 2)])
def test_nm_prune_equals_the_reference(name, n, m):
    a = _arrays()[name]
    assert _same(nm_prune(torch.from_numpy(a), n, m),
                 j_pruning.nm_prune(jnp.asarray(a), n, m))


@pytest.mark.parametrize("structured", [False, True])
def test_prune_tree_and_zero_fraction_equal_the_reference(structured):
    arrs = _arrays()
    tree = {"layers/mlp/w_up": arrs["ties"], "layers/attn/wq": arrs["3d"],
            "layers/attn_norm/w": arrs["normal"][0], "embed/table":
            arrs["normal"]}
    out, stats = prune_tree({k: torch.from_numpy(v) for k, v in tree.items()},
                            0.3, structured=structured)
    jout, jstats = j_pruning.prune_tree(
        {k: jnp.asarray(v) for k, v in tree.items()}, 0.3,
        structured=structured)
    assert set(out) == set(jout)
    assert all(_same(out[k], jout[k]) for k in out)
    assert stats["zero_weight_frac"] == pytest.approx(
        jstats["zero_weight_frac"], rel=1e-6)
    assert zero_weight_fraction(out) == pytest.approx(
        j_pruning.zero_weight_fraction(jout), rel=1e-6)
