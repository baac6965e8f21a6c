"""Fault sources in the port: the straggler watchdog and the failure
injector's fire-once, seeded-rate and delay modes.

The six serving-side tests of ``tests/test_ft.py`` under the port's mapping
(``repro.`` -> ``repro_torch.``); the three that need ``run_training`` or
the checkpointer wait for the training slice.  Then parity: one seed draws
the reference's fault and delay schedule, and the watchdog flags the same
steps on the same samples.
"""
import numpy as np
import pytest

from repro.runtime import ft as j_ft

from repro_torch.runtime import ft


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
