"""The port's LM training against the reference: ``model_api.loss_fn`` and
its gradients in all ten archs of the registry (dense qwen1.5-0.5b,
phi3-mini, h2o-danube-3 with its sliding window and codeqwen1.5; ssm
mamba2-1.3b through the oracle; hybrid hymba-1.5b; MoE granite-moe-3b-a800m
and mixtral-8x7b, whose load-balance and z losses enter the loss;
encoder-decoder whisper-base; the vision stub phi-3-vision with its patches
in the loss), the train step
of ``runtime.train`` over one and three steps, with two microbatches and
with int8 gradient compression, ``remat`` against none, the scan kernel's
refusal under autograd, and the launcher.

Weights come from the reference's ``init_params`` and cross with
``params_from_jax`` (a state with ``train_state_from_jax``); tokens, labels,
frames and patches are drawn once with numpy from a seed and fed to both
packages.  Configs are the f32 ``smoke()`` ones on the CPU.  Tolerances:
the loss within 1e-5 relative; every gradient tensor within 1e-4 of its own
max|g|; after the train steps every moment tensor within 1e-4 of its own
max (the moments are linear in the gradients), and every parameter within
1e-4 of its tensor's max|p| plus that gradient tolerance carried through
AdamW's division by sqrt(v_hat) + eps, element by element, capped at
Adam's bound of 2 lr a step only where m_hat is itself within twice the
gradient tolerance of zero (``_adam_allowance``: there its direction is
decided by rounding in both packages).  The
error-feedback residual is bf16: within one bf16 ulp of each element plus
the gradient tolerance, or one quantum off at a rounding tie (see the
compression test)."""
import dataclasses
import functools
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models.params import init_params as j_init
from repro.optim.adamw import OptConfig as JOptConfig
from repro.runtime import model_api as j_api
from repro.runtime import train as j_train

from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import train as launch_train
from repro_torch.models import ssm, transformer
from repro_torch.models.params import init_params, params_from_jax
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime import model_api, train

FAMILIES = ["qwen1.5-0.5b", "mamba2-1.3b", "hymba-1.5b",
            "granite-moe-3b-a800m", "whisper-base", "phi3-mini-3.8b",
            "h2o-danube-3-4b", "codeqwen1.5-7b", "mixtral-8x7b",
            "phi-3-vision-4.2b"]
DENSE = "qwen1.5-0.5b"
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _cfgs(arch):
    return tuple(dataclasses.replace(c, dtype="float32") for c in
                 (j_configs.get_config(arch).smoke(),
                  get_config(arch).smoke()))


@functools.lru_cache(maxsize=None)
def _params(arch):
    jc, tc = _cfgs(arch)
    jp = j_init(jc, jax.random.PRNGKey(0), max_seq=32)
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tc, "cpu")
    return jc, tc, jp, tp


def _batch(cfg, B=2, S=32, seed=0):
    """tokens and next-token labels (int32), and the family's frames or
    patches (f32), as numpy."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    b = {"tokens": t[:, :S], "labels": t[:, 1:]}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        b["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return b


def _both(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _max_err(got, want):
    """(max |got - want|, max |want|)."""
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max()), float(np.abs(want).max())


def _grads(tp, tb, tc, remat=False):
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss, metrics = model_api.loss_fn(leaves, tb, tc, remat=remat)
    loss.backward()
    return loss, metrics, {k: v.grad for k, v in leaves.items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    jc, tc, jp, tp = _params(arch)
    jb, tb = _both(_batch(jc))
    (jl, jm), jg = jax.value_and_grad(
        lambda p: j_api.loss_fn(p, jb, jc), has_aux=True)(jp)
    loss, metrics, grads = _grads(tp, tb, tc)
    assert set(metrics) == set(jm) == {"loss", "ce", "lb_loss", "z_loss"}
    for k in jm:
        d, scale = _max_err(metrics[k], jm[k])
        assert d <= LOSS_RTOL * max(scale, 1e-30), (k, d, scale)
    if tc.moe is not None:     # the auxiliaries really enter the loss
        assert float(metrics["lb_loss"].detach()) > 0
        assert float(metrics["z_loss"].detach()) > 0
        assert float(loss.detach()) != float(metrics["ce"].detach())
    assert set(grads) == set(jg)
    for k in jg:
        assert grads[k] is not None and grads[k].dtype == tp[k].dtype, k
        d, scale = _max_err(grads[k], jg[k])
        assert d <= GRAD_TOL * scale, (k, d, scale)


def _adam_allowance(js, lr, cfg):
    """Per element, how far one AdamW step may carry a gradient difference
    that is within the gradient tolerance: lr * (1e-4 * max|m_hat|) /
    (sqrt(v_hat) + eps), from the reference's moments after the step.
    Only where |m_hat| itself lies within twice that tolerance of zero is
    the step's direction decided by rounding (g / (|g| + eps) turns a
    near-zero gradient's last bits into up to a whole step); there the
    allowance is capped at Adam's own bound of 2 lr.  Everywhere else it
    stays below lr / 2 at the first step, so a step of the wrong sign, a
    missing step or a full step too many fails."""
    b1, b2 = cfg.betas
    n = int(js.opt.count)
    out = {}
    for k in js.params:
        m_hat = _np(js.opt.mu[k]) / (1 - b1 ** n)
        v_hat = _np(js.opt.nu[k]) / (1 - b2 ** n)
        tol = GRAD_TOL * np.abs(m_hat).max()
        amp = tol / (np.sqrt(v_hat) + cfg.eps)
        undecided = np.abs(m_hat) <= 2 * tol
        out[k] = lr * np.where(undecided, np.minimum(2.0, amp), amp)
    return out


def _state_errs(ts, js, allowance):
    """Every moment tensor of the port's TrainState within 1e-4 of its max
    against the reference's; every parameter within 1e-4 of its max|p| plus
    the AdamW allowance summed over the steps."""
    for k in js.params:
        got, want = _np(ts.params[k]), _np(js.params[k])
        tol = GRAD_TOL * np.abs(want).max() + allowance[k]
        assert (np.abs(got - want) <= tol).all(), \
            ("params", k, float(np.abs(got - want).max()))
        for what, t, j in (("mu", ts.opt.mu, js.opt.mu),
                           ("nu", ts.opt.nu, js.opt.nu)):
            d, scale = _max_err(t[k], j[k])
            assert d <= GRAD_TOL * scale, (what, k, d, scale)
    assert int(ts.opt.count) == int(js.opt.count)


def _run_steps(steps, microbatches=1, grad_compress=False, B=4):
    """``steps`` steps of both packages' train steps, each from the same
    state: the reference's, carried into the port with
    ``train_state_from_jax`` before every step (a chain of port steps
    drifts from the reference's by AdamW's rounding-decided directions,
    which each step's check bounds).  Returns the last (port state,
    reference state, reference state before the step, batch)."""
    jc, tc, jp, _ = _params(DENSE)
    js = j_train.init_train_state(jp, grad_compress=grad_compress)
    opt = OptConfig(**OPT)
    jstep = jax.jit(j_train.make_train_step(
        jc, JOptConfig(**OPT), microbatches=microbatches,
        grad_compress=grad_compress))
    tstep = train.make_train_step(tc, opt, microbatches=microbatches,
                                  grad_compress=grad_compress)
    for s in range(steps):
        b = _batch(jc, B=B, seed=10 + s)
        jb, tb = _both(b)
        ts = train.train_state_from_jax(jax.tree.map(np.asarray, js), tc,
                                        "cpu")
        j_before = js
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        assert set(tm) == set(jm)
        for k in jm:
            d, scale = _max_err(tm[k], jm[k])
            assert d <= LOSS_RTOL * max(scale, 1e-30), (s, k, d, scale)
        if not grad_compress:
            _state_errs(ts, js, _adam_allowance(js, float(jm["lr"]), opt))
    return ts, js, j_before, b


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_matches_reference(steps):
    _run_steps(steps)


def test_train_step_leaves_its_input_state_unchanged():
    _, tc, _, tp = _params(DENSE)
    state = train.init_train_state({k: v.clone() for k, v in tp.items()})
    copy = jax.tree.map(lambda t: t.clone(), state)
    _, tb = _both(_batch(tc))
    new, _ = train.make_train_step(tc, OptConfig(**OPT))(state, tb)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(copy)):
        assert torch.equal(a, b)
    assert not torch.equal(new.params["embed/table"],
                           state.params["embed/table"])


def test_train_step_microbatches_match_reference():
    _run_steps(1, microbatches=2)


def _bf16_ulp(x):
    """One bf16 ulp at each element of ``x`` (8 significand bits)."""
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(np.float32(1.0), e - 8)


def test_train_step_grad_compress_matches_reference():
    """One compressed step from the same state.  The int8 code of an element
    may round the other way only where the reference's ``x / s`` sits
    within the gradient tolerance of a rounding tie (1e-4 * max|x| / s =
    0.0127 codes): there the residual, the dequantized gradient and so the
    moments and the parameter differ by one quantum.  Everywhere else the
    residual ``x - deq`` is within the gradient tolerance (1e-4 * max|x|,
    which passes through the subtraction unchanged) plus one bf16 ulp of
    the element, and the moments and parameters are held as in the plain
    step."""
    ts, js, j0, b = _run_steps(1, grad_compress=True)
    jc = _params(DENSE)[0]
    jb, _ = _both(b)
    _, jg = jax.value_and_grad(lambda p: j_api.loss_fn(p, jb, jc),
                               has_aux=True)(j0.params)
    allowance = _adam_allowance(js, OPT["lr"], OptConfig(**OPT))
    flips = 0
    for k in js.params:
        x = _np(jg[k]) + _np(j0.err_fb[k])
        s = np.abs(x).max() / 127.0
        frac = np.abs(x / s) % 1.0
        near_tie = np.abs(frac - 0.5) <= GRAD_TOL * 127.0
        got, want = _np(ts.err_fb[k]), _np(js.err_fb[k])
        tol = _bf16_ulp(want) + GRAD_TOL * np.abs(x).max()
        flipped = np.abs(got - want) > tol
        assert not (flipped & ~near_tie).any(), k
        assert (np.abs(np.abs(got - want)[flipped] - s)
                <= 2 * _bf16_ulp(np.full(1, s))).all(), k
        flips += int(flipped.sum())
        keep = ~flipped
        p_got, p_want = _np(ts.params[k]), _np(js.params[k])
        ptol = GRAD_TOL * np.abs(p_want).max() + allowance[k]
        assert (np.abs(p_got - p_want) <= ptol)[keep].all(), ("params", k)
        for what, t, j in (("mu", ts.opt.mu, js.opt.mu),
                           ("nu", ts.opt.nu, js.opt.nu)):
            g, w = _np(t[k]), _np(j[k])
            assert (np.abs(g - w) <= GRAD_TOL * np.abs(w).max())[keep].all(), \
                (what, k)
        assert ts.err_fb[k].dtype == torch.bfloat16
    assert flips <= 1e-3 * sum(v.size for v in js.params.values()), flips


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_equals_no_remat_bit_for_bit(arch):
    _, tc, jp, tp = _params(arch)
    _, tb = _both(_batch(tc))
    l0, m0, g0 = _grads(tp, tb, tc, remat=False)
    l1, m1, g1 = _grads(tp, tb, tc, remat=True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(g0[k], g1[k]) for k in g0), \
        [k for k in g0 if not torch.equal(g0[k], g1[k])]
    with torch.no_grad():
        f0, _ = model_api.forward_logits(tp, tb, tc, remat=False)
        f1, _ = model_api.forward_logits(tp, tb, tc, remat=True)
    assert torch.equal(f0, f1)


def _scan_inputs(requires_grad):
    g = torch.Generator().manual_seed(0)
    B, S, H, P, G, N = 1, 16, 2, 4, 1, 4
    x = torch.randn((B, S, H, P), generator=g)
    dt = torch.rand((B, S, H), generator=g) * 0.1
    A = -torch.rand((H,), generator=g)
    Bm = torch.randn((B, S, G, N), generator=g)
    C = torch.randn((B, S, G, N), generator=g)
    D = torch.ones((H,))
    x.requires_grad_(requires_grad)
    return x, dt, A, Bm, C, D


def test_ssd_chunked_kernel_refuses_autograd():
    args = _scan_inputs(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_ops.ssd_chunked_kernel(*args, 8)
    with torch.no_grad():                       # no graph: it runs
        y, st = ssd_ops.ssd_chunked_kernel(*args, 8)
    y2, _ = ssd_ops.ssd_chunked_kernel(*_scan_inputs(False), 8)
    assert torch.equal(y, y2)
    # a CUDA wrapper refuses before it looks for the card
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_ops._refuse_grad("ssd_scan_cuda", *args)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_train_step_takes_the_scan_oracle(arch, monkeypatch):
    """Training passes ``use_kernel=False`` to every ``ssm_block`` and never
    reaches the kernel's entry point; the launch counters stay 0."""
    _, tc, _, tp = _params(arch)
    seen, kernel_calls = [], []
    real_block = ssm.ssm_block

    def spy_block(*a, **kw):
        seen.append(kw.get("use_kernel"))
        return real_block(*a, **kw)

    def spy_kernel(*a, **kw):
        kernel_calls.append(1)
        raise AssertionError("the train step reached ssd_chunked_kernel")

    monkeypatch.setattr(ssm, "ssm_block", spy_block)
    monkeypatch.setattr(ssd_ops, "ssd_chunked_kernel", spy_kernel)
    for fn in (ssd_ops.ssd_scan_cuda, ssd_ops.ssd_chunk_state_cuda,
               ssd_ops.ssd_state_pass_cuda, ssd_ops.ssd_chunk_scan_cuda):
        monkeypatch.setattr(fn, "launches", 0)
    _, tb = _both(_batch(tc))
    state = train.init_train_state(tp)
    train.make_train_step(tc, OptConfig(**OPT))(state, tb)
    assert seen and all(u is False for u in seen), seen
    assert not kernel_calls
    assert ssd_ops.ssd_scan_cuda.launches == 0
    # the serving default stays auto (None)
    seen.clear()
    with torch.no_grad():
        transformer.forward(tp, tb["tokens"], tc)
    assert seen and all(u is None for u in seen)


def test_mesh_and_tp_raise_not_implemented():
    """The mesh path, which once raised, on a one-rank (1, 1) mesh
    (``make_local_mesh`` starts a gloo group in this process): two
    microbatches with remat through ``jit_train_step`` from the
    one-device state land where ``make_train_step(mesh=None)`` does, bit
    for bit (one rank runs the same local ops), in the layouts
    ``state_shardings`` gives, with plain 0-d metrics.  (Multi-rank meshes:
    ``tests/test_torch_distributed.py``.)"""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    _, tc, _, tp = _params(DENSE)
    _, tb = _both(_batch(tc, B=4))
    opt = OptConfig(**OPT)
    state = train.init_train_state(tp)
    s1, m1 = train.make_train_step(tc, opt, microbatches=2)(state, tb)
    mesh = make_local_mesh(device="cpu")
    try:
        step = train.jit_train_step(tc, opt, mesh, state, tb, microbatches=2)
        s2, m2 = step(state, tb)
        sh = train.state_shardings(tc, state, mesh)
        for k in ("loss", "grad_norm"):
            assert type(m2[k]) is torch.Tensor and m2[k].ndim == 0
            assert torch.equal(m2[k], m1[k]), k
        for k in tp:
            assert tuple(s2.params[k].placements) == sh.params[k].placements
            for a, b in ((s2.params[k], s1.params[k]),
                         (s2.opt.mu[k], s1.opt.mu[k]),
                         (s2.opt.nu[k], s1.opt.nu[k])):
                assert torch.equal(a.full_tensor(), b), k
    finally:
        dist.destroy_process_group()


def test_train_state_from_jax_crosses_bit_for_bit():
    jc, tc, jp, _ = _params(DENSE)
    bf = dataclasses.replace(jc, dtype="bfloat16")
    js = j_train.init_train_state(j_init(bf, jax.random.PRNGKey(1),
                                         max_seq=32), grad_compress=True)
    rng = np.random.default_rng(3)
    js = js._replace(
        opt=js.opt._replace(
            mu={k: jnp.asarray(rng.standard_normal(v.shape), jnp.float32)
                for k, v in js.opt.mu.items()},
            count=jnp.int32(7)),
        err_fb={k: jnp.asarray(rng.standard_normal(v.shape), jnp.bfloat16)
                for k, v in js.err_fb.items()})
    host = jax.tree.map(np.asarray, js)
    ts = train.train_state_from_jax(
        host, dataclasses.replace(tc, dtype="bfloat16"), "cpu")
    assert int(ts.opt.count) == 7 and ts.opt.count.dtype == torch.int32
    for k in host.params:
        for t, h in ((ts.params[k], host.params[k]),
                     (ts.opt.mu[k], host.opt.mu[k]),
                     (ts.err_fb[k], host.err_fb[k])):
            if t.dtype == torch.bfloat16:
                assert np.array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(h).view(np.int16)), k
            else:
                assert np.array_equal(t.numpy(), np.asarray(h)), k


def test_launcher_smoke_on_cpu(tmp_path):
    out = io.StringIO()
    with redirect_stdout(out):
        result = launch_train.main(
            ["--smoke", "--device", "cpu", "--steps", "3", "--seq", "32",
             "--batch", "4", "--ckpt-dir", str(tmp_path / "ck")])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("arch=qwen1.5-0.5b-smoke params=")
    assert lines[-1].startswith("done: steps=3 restarts=0 loss ")
    assert "stragglers_flagged=" in lines[-1]
    assert result.final_step == 3 and len(result.metrics_log) == 3
    n = sum(p.numel() for p in init_params(
        get_config(DENSE).smoke(), torch.Generator().manual_seed(0),
        max_seq=32, device="cpu").values())
    assert lines[0].split("params=")[1].split()[0] == f"{n:,}"


def report() -> dict:
    """The worst errors the tests above bound, measured: per family the
    loss's relative error and the worst gradient tensor's error over its
    max|g|; per step case the worst parameter and moment errors over each
    tensor's max.  ``python tests/test_torch_train.py`` prints them."""
    out = {}
    for arch in FAMILIES:
        jc, tc, jp, tp = _params(arch)
        jb, tb = _both(_batch(jc))
        (jl, _), jg = jax.value_and_grad(
            lambda p: j_api.loss_fn(p, jb, jc), has_aux=True)(jp)
        loss, _, grads = _grads(tp, tb, tc)
        d, scale = _max_err(loss, jl)
        worst = max((_max_err(grads[k], jg[k])[0]
                     / max(_max_err(grads[k], jg[k])[1], 1e-30), k)
                    for k in jg)
        out[arch] = {"loss_rel": d / scale, "worst_grad": worst}
    for label, kw in (("1 step", dict(steps=1)), ("3 steps", dict(steps=3)),
                      ("microbatches=2", dict(steps=1, microbatches=2)),
                      ("grad_compress", dict(steps=1, grad_compress=True))):
        ts, js, _, _ = _run_steps(**kw)
        row = {}
        for what, t, j in (("params", ts.params, js.params),
                           ("mu", ts.opt.mu, js.opt.mu),
                           ("nu", ts.opt.nu, js.opt.nu)):
            row[what] = max((_max_err(t[k], j[k])[0]
                             / max(_max_err(t[k], j[k])[1], 1e-30), k)
                            for k in j)
        out[label] = row
    return out


if __name__ == "__main__":
    import json
    print(json.dumps(report(), indent=1))
