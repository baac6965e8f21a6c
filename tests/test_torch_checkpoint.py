"""The port's checkpointer: the five tests of ``tests/test_checkpoint.py``
under the port's mapping (``restore`` gives tensors; the elastic restore
places leaves on a ``torch.device``), then the two packages' checkpoints
across: a checkpoint the reference writes, with bf16, f32 and int32 leaves,
restores in the port bit for bit, and one the port writes restores in the
reference bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as j_ckpt

from repro_torch.ckpt import checkpoint as ckpt


def _tree():
    return {"params": {"a/w": torch.arange(6.0).reshape(2, 3),
                       "b/w": torch.ones((4,), dtype=torch.bfloat16)},
            "opt": {"mu": {"a/w": torch.zeros((2, 3))}},
            "count": {"count": torch.tensor(5, dtype=torch.int32)}}


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(t, str(tmp_path), 3)
    t2, step, extra = ckpt.restore(str(tmp_path))
    assert step == 3
    assert torch.equal(t2["params"]["a/w"], t["params"]["a/w"])
    assert t2["params"]["b/w"].dtype == torch.bfloat16
    assert int(t2["count"]["count"]) == 5


def test_async_checkpointer_and_gc(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        saver.save(_tree(), s)
    saver.wait()
    saver._gc()
    assert ckpt.list_steps(str(tmp_path)) == [3, 4]


def test_restore_specific_step(tmp_path):
    for s in (1, 2):
        t = _tree()
        t["count"]["count"] = torch.tensor(s, dtype=torch.int32)
        ckpt.save(t, str(tmp_path), s)
    t1, s1, _ = ckpt.restore(str(tmp_path), step=1)
    assert int(t1["count"]["count"]) == 1


def test_elastic_restore_new_sharding(tmp_path):
    """Checkpoint written unsharded restores onto explicit device placement
    (the single-device degenerate case of re-mesh restore)."""
    ckpt.save(_tree(), str(tmp_path), 1)
    shardings = {"params": {"a/w": torch.device("cpu"), "b/w": None},
                 "opt": {"mu": {"a/w": None}}, "count": {"count": None}}
    t, _, _ = ckpt.restore(str(tmp_path), shardings=shardings)
    assert isinstance(t["params"]["a/w"], torch.Tensor)
    assert t["params"]["a/w"].device == torch.device("cpu")
    assert torch.equal(t["params"]["a/w"], torch.arange(6.0).reshape(2, 3))


def test_missing_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "nope"))


# -- across the two packages ----------------------------------------------------

def _host_leaves():
    rng = np.random.default_rng(0)
    return {"params": {"layers/attn/wq": rng.standard_normal((2, 8, 8)),
                       "embed/table": rng.standard_normal((16, 8))},
            "mu": {"layers/attn/wq": rng.standard_normal((2, 8, 8))},
            "count": {"count": 7}}


def _jax_tree():
    h = _host_leaves()
    return {"params": {k: jnp.asarray(v, jnp.bfloat16)
                       for k, v in h["params"].items()},
            "mu": {k: jnp.asarray(v, jnp.float32)
                   for k, v in h["mu"].items()},
            "count": {"count": jnp.int32(h["count"]["count"])}}


def _torch_tree():
    h = _host_leaves()
    return {"params": {k: torch.tensor(v, dtype=torch.bfloat16)
                       for k, v in h["params"].items()},
            "mu": {k: torch.tensor(v, dtype=torch.float32)
                   for k, v in h["mu"].items()},
            "count": {"count": torch.tensor(h["count"]["count"],
                                            dtype=torch.int32)}}


def _bits_t(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _bits_j(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if str(a.dtype) == "bfloat16" else a


def _flat(tree):
    return {k: v for k, v in ckpt._flatten(tree).items()}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jt = _jax_tree()
    j_ckpt.save(jt, str(tmp_path), 4, {"data_step": 4})
    t, step, extra = ckpt.restore(str(tmp_path))
    assert step == 4 and extra == {"data_step": 4}
    want, got = _flat(jt), _flat(t)
    assert set(want) == set(got)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32,
              "int32": torch.int32}
    for k in want:
        assert got[k].dtype == dtypes[str(want[k].dtype)], k
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert np.array_equal(_bits_t(got[k]), _bits_j(want[k])), k


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tt = _torch_tree()
    ckpt.save(tt, str(tmp_path), 9, {"data_step": 9})
    j, step, extra = j_ckpt.restore(str(tmp_path))
    assert step == 9 and extra == {"data_step": 9}
    want, got = _flat(tt), _flat(j)
    assert set(want) == set(got)
    for k in want:
        assert str(np.asarray(got[k]).dtype) == \
            str(want[k].dtype).removeprefix("torch."), k
        assert np.array_equal(_bits_j(got[k]), _bits_t(want[k])), k
    # and the reference's elastic restore places it on its device
    j2, _, _ = j_ckpt.restore(str(tmp_path), shardings={
        "params": {"embed/table": jax.devices()[0]}})
    assert isinstance(j2["params"]["embed/table"], jax.Array)


def test_async_save_snapshots_before_it_returns(tmp_path):
    """The tree is copied to host memory before ``save`` returns: writing
    to the tensors afterwards does not reach the checkpoint."""
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    t = _torch_tree()
    before = t["mu"]["layers/attn/wq"].clone()
    saver.save(t, 1)
    t["mu"]["layers/attn/wq"].add_(1.0)
    saver.wait()
    r, _, _ = ckpt.restore(str(tmp_path))
    assert torch.equal(r["mu"]["layers/attn/wq"], before)
