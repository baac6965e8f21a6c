"""Fault tolerance in the port: the training loop's restart against the
uninterrupted run, the straggler watchdog and the failure injector's
fire-once, seeded-rate and delay modes.

The nine tests of ``tests/test_ft.py`` under the port's mapping
(``repro.`` -> ``repro_torch.``): the three training ones run the port's
``run_training`` on its own bf16 smoke weights and token stream (the
reference's ``_setup``: qwen1.5-0.5b, batch 4 of 32 tokens, seed 7).  Then
parity: one seed draws the reference's fault and delay schedule, and the
watchdog flags the same steps on the same samples.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.runtime import ft as j_ft

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data.tokens import DataConfig
from repro_torch.models.params import init_params
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime import ft
from repro_torch.runtime.train import init_train_state, make_train_step

ARCH = "qwen1.5-0.5b"


def _setup(steps=12):
    cfg = get_config(ARCH).smoke()
    params = init_params(cfg, torch.Generator().manual_seed(0), max_seq=32,
                         device="cpu")
    state = init_train_state(params)
    step = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=1,
                                          total_steps=steps))
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=7)
    return cfg, state, step, data


def test_restart_bit_identical_to_uninterrupted(tmp_path):
    steps = 12
    cfg, state, step, data = _setup(steps)
    # uninterrupted run
    ft.run_training(step, state, data, steps, str(tmp_path / "a"),
                    ckpt_every=4)
    # interrupted run: inject failures at steps 5 and 9
    r2 = ft.run_training(step, state, data, steps, str(tmp_path / "b"),
                         ckpt_every=4,
                         injector=ft.FailureInjector(fail_at=[5, 9]))
    assert r2.restarts == 2
    t1, s1, _ = ckpt.restore(str(tmp_path / "a"))
    t2, s2, _ = ckpt.restore(str(tmp_path / "b"))
    assert s1 == s2 == steps
    for part in ("params", "mu", "nu", "count"):
        for k in t1[part]:
            assert torch.equal(t1[part][k], t2[part][k]), (part, k)
    assert t1["params"]["embed/table"].dtype == torch.bfloat16
    # the run changed the weights it started from, and left them as they were
    assert not torch.equal(t1["params"]["embed/table"],
                           state.params["embed/table"])
    assert torch.equal(init_params(cfg, torch.Generator().manual_seed(0),
                                   max_seq=32, device="cpu")["embed/table"],
                       state.params["embed/table"])


def test_loss_decreases_over_training(tmp_path):
    steps = 15
    cfg, state, step, data = _setup(steps)
    r = ft.run_training(step, state, data, steps, str(tmp_path / "c"),
                        ckpt_every=50)
    losses = [m["loss"] for m in r.metrics_log]
    assert losses[-1] < losses[0], losses


def test_run_training_resumes_from_the_latest_checkpoint(tmp_path):
    """A second call on the same directory resumes where the first ended
    (the data cursor is the step) and ends where one longer run ends."""
    cfg, state, step, data = _setup(6)
    ft.run_training(step, state, data, 6, str(tmp_path / "a"), ckpt_every=3)
    ft.run_training(step, state, data, 3, str(tmp_path / "b"), ckpt_every=3)
    r = ft.run_training(step, state, data, 6, str(tmp_path / "b"),
                        ckpt_every=3)
    assert [m["step"] for m in r.metrics_log] == [3, 4, 5]
    t1, _, _ = ckpt.restore(str(tmp_path / "a"))
    t2, _, _ = ckpt.restore(str(tmp_path / "b"))
    assert all(torch.equal(t1["params"][k], t2["params"][k])
               for k in t1["params"])


def test_run_training_refuses_a_checkpoint_of_another_config(tmp_path):
    """A checkpoint left by another model or other options in the same
    directory stops the run before any step, with ``ValueError`` (not the
    restart path, and not a silent resume)."""
    cfg, state, step, data = _setup(4)
    ft.run_training(step, state, data, 2, str(tmp_path / "a"))
    wide = get_config(ARCH).smoke()
    wide = dataclasses.replace(wide, d_ff=2 * wide.d_ff)
    other = init_train_state(init_params(
        wide, torch.Generator().manual_seed(0), max_seq=32, device="cpu"))
    with pytest.raises(ValueError, match="mlp"):
        ft.run_training(make_train_step(wide, OptConfig()), other, data, 4,
                        str(tmp_path / "a"))
    f32 = init_train_state({k: v.float() for k, v in state.params.items()})
    with pytest.raises(ValueError, match="float32"):
        ft.run_training(step, f32, data, 4, str(tmp_path / "a"))
    with pytest.raises(ValueError, match="error feedback"):
        ft.run_training(step, init_train_state(state.params,
                                               grad_compress=True),
                        data, 4, str(tmp_path / "a"))
    assert ckpt.latest_step(str(tmp_path / "a")) == 2


def test_run_training_refuses_state_shardings(tmp_path):
    """``state_shardings``, which once raised, re-meshes a restored state:
    two steps on one device leave a checkpoint, and the run resumes from
    it on a one-rank (1, 1) mesh (``make_local_mesh`` starts a gloo group
    in this process) through ``jit_train_step``, its state restored onto
    ``state_shardings``' layouts; its losses are the uninterrupted
    one-device run's within 1e-5 relative."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime.train import jit_train_step, state_shardings
    cfg, state, step, data = _setup(4)
    whole = ft.run_training(step, state, data, 4, str(tmp_path / "whole"))
    ft.run_training(step, state, data, 2, str(tmp_path / "a"))
    mesh = make_local_mesh(device="cpu")
    try:
        sh = state_shardings(cfg, state, mesh)
        batch = {"tokens": torch.zeros((4, 32), dtype=torch.int32),
                 "labels": torch.zeros((4, 32), dtype=torch.int32)}
        mstep = jit_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=1,
                                              total_steps=4),
                               mesh, state, batch)
        seen = []

        def spy(st, b):
            seen.append(st.params["embed/table"])
            return mstep(st, b)

        res = ft.run_training(spy, state, data, 4, str(tmp_path / "a"),
                              state_shardings=sh)
        assert res.final_step == 4 and [e["step"] for e in res.metrics_log] \
            == [2, 3]
        assert tuple(seen[0].placements) == sh.params["embed/table"].placements
        for got, want in zip(res.metrics_log, whole.metrics_log[2:]):
            assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    finally:
        dist.destroy_process_group()


def test_straggler_watchdog_flags_slow_steps():
    wd = ft.StragglerWatchdog(factor=3.0, window=10)
    for i in range(10):
        wd.observe(i, 0.1)
    assert wd.observe(10, 0.5)          # 5x median -> flagged
    assert not wd.observe(11, 0.12)
    assert wd.flagged == [10]


def test_straggler_watchdog_history_is_bounded():
    # regression: times grew unbounded over a long run even though only the
    # last `window` samples ever feed the median
    wd = ft.StragglerWatchdog(factor=3.0, window=8)
    for i in range(10_000):
        wd.observe(i, 0.1)
    assert len(wd.times) == 8
    # the bounded buffer must behave identically to the old last-window slice:
    # after 8 fast steps the median is fast, so a 5x step still flags
    assert wd.observe(10_000, 0.5)
    assert wd.flagged == [10_000]


def test_injector_rate_mode_is_seeded_and_counted():
    def draws(seed):
        inj = ft.FailureInjector(rate=0.3, seed=seed)
        out = []
        for step in range(50):
            try:
                inj.maybe_fail(step)
                out.append(False)
            except RuntimeError:
                out.append(True)
        return out, inj.injected_failures

    a, na = draws(seed=7)
    b, nb = draws(seed=7)
    c, nc = draws(seed=8)
    assert a == b and na == nb          # same seed -> same fault sequence
    assert a != c                        # different seed -> different faults
    assert na == sum(a) > 0


def test_injector_delay_modes():
    slept = []
    inj = ft.FailureInjector(delay_at=[3], delay_s=0.25, sleep=slept.append)
    assert not inj.maybe_delay(2)
    assert inj.maybe_delay(3)
    assert not inj.maybe_delay(3)        # fire-once, like fail_at
    assert slept == [0.25]
    assert inj.injected_delays == 1
    # seeded probabilistic delays, independent of the failure stream
    slept2 = []
    inj2 = ft.FailureInjector(rate=0.0, delay_rate=0.5, delay_s=0.01,
                              seed=3, sleep=slept2.append)
    hits = sum(inj2.maybe_delay(s) for s in range(100))
    assert hits == len(slept2) == inj2.injected_delays
    assert 20 < hits < 80                # seeded draw near the configured rate


def test_injector_fail_at_api_unchanged():
    inj = ft.FailureInjector(fail_at=[2])
    inj.maybe_fail(1)
    try:
        inj.maybe_fail(2)
        assert False, "should have raised"
    except RuntimeError:
        pass
    inj.maybe_fail(2)                    # fire-once: second pass is clean
    assert inj.fired == {2}


def test_injector_validates_config():
    with pytest.raises(ValueError):
        ft.FailureInjector(rate=1.5)
    with pytest.raises(ValueError):
        ft.FailureInjector(delay_rate=-0.1)
    with pytest.raises(ValueError):
        ft.FailureInjector(delay_s=-1.0)


def _schedule(mod, seed):
    inj = mod.FailureInjector(fail_at=[4], rate=0.2, seed=seed,
                              delay_at=[7], delay_rate=0.3, delay_s=0.5,
                              sleep=lambda s: None)
    out = []
    for step in range(60):
        delayed = inj.maybe_delay(step)
        try:
            inj.maybe_fail(step)
            failed = False
        except RuntimeError:
            failed = True
        out.append((delayed, failed))
    return out, inj.injected_failures, inj.injected_delays


@pytest.mark.parametrize("seed", [0, 3, 7, 123])
def test_injector_schedule_equals_the_reference(seed):
    assert _schedule(ft, seed) == _schedule(j_ft, seed)


def test_watchdog_flags_equal_the_reference():
    dts = np.random.default_rng(5).exponential(0.1, 300)
    dts[::37] *= 8.0                      # injected spikes
    t, j = ft.StragglerWatchdog(window=12), j_ft.StragglerWatchdog(window=12)
    assert [t.observe(i, float(d)) for i, d in enumerate(dts)] == \
        [j.observe(i, float(d)) for i, d in enumerate(dts)]
    assert t.flagged == j.flagged and t.flagged


def test_failure_mid_save_keeps_last_good_checkpoint(tmp_path):
    """Atomic rename: a .tmp dir never shadows the last good step."""
    tree = {"params": {"w": torch.ones(4)}}
    ckpt.save(tree, str(tmp_path), 10)
    # simulate a crashed save: leave a stale tmp dir
    os.makedirs(str(tmp_path / "step_00000020.tmp"))
    assert ckpt.latest_step(str(tmp_path)) == 10
    t, s, _ = ckpt.restore(str(tmp_path))
    assert s == 10
