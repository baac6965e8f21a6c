"""The port's SPMD path against the reference, on gloo ranks on the CPU.

The five tests of ``tests/test_distributed.py`` under the port's mapping
(a ``DeviceMesh`` over gloo ranks where the reference forces eight host
devices), then the SSM prefill on a mesh (the scan on each rank's local
heads, uneven for hymba), a checkpoint restored onto placements, and the
scan's refusal of DTensors.  Each multi-rank test runs N processes of
``python`` joined by a ``FileStore`` under ``tmp_path``; the reference's
numbers are computed here and handed over through ``torch.save`` files.  A
rank that fails stops the others, and a run that outlives ``RANK_TIMEOUT``
seconds fails the test, so a hung collective cannot hold the suite.  The
ranks run at a lower priority than the rest of the suite.

Tolerances are the reference's: the sharded train step within 2e-2
relative of the single-device loss and gradient norm, each parameter
within 5e-2 of its tensor's max (zero-init q/k/v biases skipped, as there);
the expert-parallel MoE block within 1e-3 of the local block's max, its
load-balance loss within 0.5-2x; the ``dist`` target within 1e-5; the SSM
prefill within 1e-5 of the one-device prefill's max |logit| (f32).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as j_get_config
from repro.configs.mnist_cnn import CONFIG as J_CNN
from repro.core.passes import PassManager as JPassManager
from repro.core.passes import structural_pipeline as j_structural
from repro.core.reader import cnn_to_ir as j_cnn_to_ir
from repro.core.writers.jax_writer import JaxWriter
from repro.models import cnn as j_cnn
from repro.models.moe import MoELayerParams as JMoEParams
from repro.models.moe import moe_block as j_moe_block
from repro.models.params import init_params as j_init
from repro.models.params import moe_factors
from repro.optim.adamw import OptConfig as JOptConfig
from repro.runtime import train as j_train

from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models.params import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 300

PRELUDE = """\
import os
# below the suite's other workers, whose timed tests would otherwise wait
# on N busy ranks
os.nice(10)
import numpy as np
import torch
import torch.distributed as dist
RANK, N = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", store=dist.FileStore(os.environ["STORE"], N),
                        rank=RANK, world_size=N)
DATA = os.environ["DATA"]
torch.manual_seed(0)
"""

EPILOGUE = """
dist.barrier()
dist.destroy_process_group()
"""


def _run_ranks(tmp_path, n: int, body: str, timeout: float = RANK_TIMEOUT):
    """Run ``body`` on ``n`` gloo ranks; returns rank 0's output."""
    script = tmp_path / "rank.py"
    script.write_text(PRELUDE + textwrap.dedent(body) + EPILOGUE)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               WORLD_SIZE=str(n), STORE=str(tmp_path / "store"),
               DATA=str(tmp_path), OMP_NUM_THREADS="1")
    logs = [tmp_path / f"rank{r}.log" for r in range(n)]
    procs = []
    for r in range(n):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(script)], env=dict(env, RANK=str(r)),
                stdout=f, stderr=subprocess.STDOUT, cwd=str(tmp_path)))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break                  # one rank failed: the others would hang
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        r = failed[0]
        late = time.monotonic() > deadline
        pytest.fail(f"{'timed out after ' + str(timeout) + ' s; ' if late else ''}"
                    f"rank {r} exited {procs[r].returncode}:\n"
                    f"{logs[r].read_text()[-4000:]}")
    return logs[0].read_text()


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group in this process (``make_local_mesh`` starts
    it), destroyed after the test."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the five tests of tests/test_distributed.py
# ---------------------------------------------------------------------------

# the f32 step's cases: (name, make_train_step keywords)
F32_CASES = (("plain", {}), ("microbatches", {"microbatches": 2}),
             ("compress", {"grad_compress": True}))


def test_sharded_train_step_matches_single_device(tmp_path):
    """2x4 mesh ``jit_train_step`` == the port's single-device step and the
    reference's single-device step on the same state and batch; then both
    in two microbatches, and with int8 gradient compression (the residuals
    in the ZeRO-1 layout).

    The bf16 step's parameters cannot show one AdamW update (1e-3 is under
    a bf16 ulp of a 1.0 norm weight, and 0.1-1% of a weight's max), so the
    same three steps also run in f32, where the mesh's moments must equal
    the one-device step's within 1e-3 of each max and its update
    (new - old parameters) the one-device and the reference's update
    within 1e-2 of that update's max plus the AdamW allowance of the
    moment tolerance (``_adam_allowance`` in ``test_torch_train.py``).
    Under compression one int8 quantum more (1/127 of the max in mu, 2/127
    in nu): a rounding tie in another sum order moves a code by one."""
    jc = j_get_config("qwen1.5-0.5b").smoke()
    tc = get_config("qwen1.5-0.5b").smoke()
    jp = j_init(jc, jax.random.PRNGKey(0), max_seq=32)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jc.vocab, (8, 32)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    opt = JOptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    s1, m1 = jax.jit(j_train.make_train_step(jc, opt))(
        j_train.init_train_state(jp), jbatch)
    jc32 = dataclasses.replace(jc, dtype="float32")
    jp32 = j_init(jc32, jax.random.PRNGKey(0), max_seq=32)
    ref32 = {}
    for case, kw in F32_CASES:
        r1, _ = jax.jit(j_train.make_train_step(jc32, opt, **kw))(
            j_train.init_train_state(
                jp32, grad_compress=kw.get("grad_compress", False)), jbatch)
        ref32[case] = {k: np.asarray(r1.params[k]) - np.asarray(jp32[k])
                       for k in jp32}
    torch.save({
        "params": params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                                  tc, "cpu"),
        "params32": params_from_jax(
            {k: np.asarray(v) for k, v in jp32.items()},
            dataclasses.replace(tc, dtype="float32"), "cpu"),
        "ref_delta32": ref32, "cases": F32_CASES,
        "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
        "loss": float(m1["loss"]), "grad_norm": float(m1["grad_norm"]),
        "ref_params": {k: np.asarray(v, np.float32)
                       for k, v in s1.params.items()},
    }, tmp_path / "in.pt")
    out = _run_ranks(tmp_path, 8, """
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import compat_make_mesh
        from repro_torch.optim.adamw import OptConfig
        from repro_torch.runtime import train
        d = torch.load(os.path.join(DATA, "in.pt"), weights_only=False)
        cfg = get_config("qwen1.5-0.5b").smoke()
        opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
        state = train.init_train_state(d["params"])
        s1, m1 = train.make_train_step(cfg, opt)(state, d["batch"])
        mesh = compat_make_mesh((2, 4), ("data", "model"))
        step = train.jit_train_step(cfg, opt, mesh, state, d["batch"])
        s2, m2 = step(state, d["batch"])
        sh = train.state_shardings(cfg, state, mesh)
        for k, v in s2.params.items():
            assert tuple(v.placements) == sh.params[k].placements, k
        for k, v in s2.opt.mu.items():
            assert tuple(v.placements) == sh.opt.mu[k].placements, k
        full = {k: v.full_tensor().float().numpy() for k, v in s2.params.items()}
        l2, g2 = float(m2["loss"]), float(m2["grad_norm"])
        for what, l1, g1, p1 in (
                ("port", float(m1["loss"]), float(m1["grad_norm"]),
                 {k: v.float().numpy() for k, v in s1.params.items()}),
                ("reference", d["loss"], d["grad_norm"], d["ref_params"])):
            assert abs(l1 - l2) / abs(l1) < 2e-2, (what, l1, l2)
            assert abs(g1 - g2) / abs(g1) < 2e-2, (what, g1, g2)
            for k in p1:
                if k.endswith(("/bq", "/bk", "/bv")):
                    # zero-init biases: Adam's first update is +-lr * sign(g)
                    # and tiny bf16 grads flip sign under other sum orders
                    continue
                rel = np.max(np.abs(p1[k] - full[k])) / (np.max(np.abs(p1[k])) + 1e-6)
                assert rel < 5e-2, (what, k, rel)
        # two microbatches: each the reference's rows of the batch, sharded
        # over the data axis again
        _, mb1 = train.make_train_step(cfg, opt, microbatches=2)(
            state, d["batch"])
        _, mb2 = train.jit_train_step(cfg, opt, mesh, state, d["batch"],
                                      microbatches=2)(state, d["batch"])
        for k in ("loss", "grad_norm"):
            a, b = float(mb1[k]), float(mb2[k])
            assert abs(a - b) < 2e-2 * abs(a), (k, a, b)
        # int8 gradient compression with error feedback on the mesh: the
        # same step on DTensor gradients, within the same tolerances
        sc = train.init_train_state(d["params"], grad_compress=True)
        c1, mc1 = train.make_train_step(cfg, opt, grad_compress=True)(
            sc, d["batch"])
        c2, mc2 = train.jit_train_step(cfg, opt, mesh, sc, d["batch"],
                                       grad_compress=True)(sc, d["batch"])
        assert abs(float(mc1["loss"]) - float(mc2["loss"])) < 2e-2 * abs(
            float(mc1["loss"]))
        for k, v in c2.err_fb.items():
            assert tuple(v.placements) == sh.opt.mu[k].placements, k
            a, b = c1.params[k].float(), c2.params[k].full_tensor().float()
            if not k.endswith(("/bq", "/bk", "/bv")):
                assert float((a - b).abs().max()) < 5e-2 * float(
                    a.abs().max()), k
        # f32: the moments and the update itself
        import dataclasses
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        b1, b2 = opt.betas
        for case, kw in d["cases"]:
            st = train.init_train_state(
                d["params32"], grad_compress=kw.get("grad_compress", False))
            o1, _ = train.make_train_step(cfg32, opt, **kw)(st, d["batch"])
            o2, om = train.jit_train_step(cfg32, opt, mesh, st, d["batch"],
                                          **kw)(st, d["batch"])
            q = 1 / 127 if "grad_compress" in kw else 0.0
            n, lr = int(o1.opt.count), float(om["lr"])
            assert int(o2.opt.count.full_tensor()) == n == 1
            for k, p0 in st.params.items():
                mu1, nu1 = o1.opt.mu[k], o1.opt.nu[k]
                for what, a, b, tol in (
                        ("mu", mu1, o2.opt.mu[k], 1e-3 + q),
                        ("nu", nu1, o2.opt.nu[k], 1e-3 + 2 * q)):
                    err = float((a - b.full_tensor()).abs().max())
                    assert err <= tol * float(a.abs().max()), (
                        case, what, k, err)
                # as _adam_allowance: a gradient within gtol of max|m_hat|
                # moves the step by gtol / (sqrt(v_hat) + eps), up to 2 lr
                # where m_hat lies within 2 gtol of zero
                m_hat, v_hat = mu1 / (1 - b1 ** n), nu1 / (1 - b2 ** n)
                gtol = (1e-3 + q) * float(m_hat.abs().max())
                amp = gtol / (v_hat.sqrt() + opt.eps)
                allow = lr * torch.where(m_hat.abs() <= 2 * gtol,
                                         amp.clamp(max=2.0), amp)
                d2 = o2.params[k].full_tensor() - p0
                for what, want in (
                        ("port", o1.params[k] - p0),
                        ("reference",
                         torch.from_numpy(d["ref_delta32"][case][k]))):
                    bad = (d2 - want).abs() > (
                        1e-2 * want.abs().max() + allow)
                    assert not bool(bad.any()), (
                        case, what, k, int(bad.sum()),
                        float((d2 - want).abs().max()),
                        float(want.abs().max()))
        if RANK == 0:
            print("OK sharded==single", l2, g2)
    """)
    assert "OK sharded==single" in out


def _to_ep(w, last_is_d, ep, tp, E, f):
    """(L, 1, E, d, f) -> (L, ep*tp, E/ep, d, f/tp), the reference test's
    expert-parallel relayout (w_down (E, f, d) splits f too)."""
    L = w.shape[0]
    w = w[:, 0]
    if last_is_d:
        d = w.shape[-1]
        w = w.reshape(L, ep, E // ep, tp, f // tp, d)
        return w.transpose(0, 1, 3, 2, 4, 5).reshape(L, ep * tp, E // ep,
                                                     f // tp, d)
    d = w.shape[2]
    w = w.reshape(L, ep, E // ep, d, tp, f // tp)
    return w.transpose(0, 1, 4, 2, 3, 5).reshape(L, ep * tp, E // ep, d,
                                                 f // tp)


def test_moe_shard_map_matches_local(tmp_path):
    """The expert-parallel ``moe_block`` on a 2x4 mesh == the reference's
    local block on the same weights (no token drops at capacity 4)."""
    cfg = dataclasses.replace(j_get_config("granite-moe-3b-a800m").smoke(),
                              dtype="float32")
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    p1 = j_init(cfg, jax.random.PRNGKey(0), max_seq=32, tp_total=1)
    E, f, d = cfg.moe.n_experts, cfg.moe.d_ff_expert, cfg.d_model
    ep, tp = moe_factors(E, 4)
    x = np.array(jax.random.normal(jax.random.PRNGKey(2), (2, 16, d),
                                   jnp.float32))
    lp = JMoEParams(router=p1["layers/moe/router"][0],
                    w_gate=p1["layers/moe/w_gate"][0],
                    w_up=p1["layers/moe/w_up"][0],
                    w_down=p1["layers/moe/w_down"][0])
    y1, lb1, z1 = j_moe_block(jnp.asarray(x), lp, cfg, None, 1)
    ep_w = {k: torch.from_numpy(np.array(_to_ep(
        np.asarray(p1[f"layers/moe/{k}"]), k == "w_down", ep, tp, E, f)[0]))
        for k in ("w_gate", "w_up", "w_down")}
    torch.save({"x": torch.from_numpy(x), "w": ep_w,
                "router": torch.from_numpy(np.array(lp.router)),
                "y1": np.asarray(y1), "lb1": float(lb1)}, tmp_path / "in.pt")
    out = _run_ranks(tmp_path, 8, """
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import compat_make_mesh
        from repro_torch.models.moe import MoELayerParams, moe_block
        from repro_torch.sharding import batch_spec, param_spec, place
        d = torch.load(os.path.join(DATA, "in.pt"), weights_only=False)
        cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").smoke(),
                                  dtype="float32")
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
        mesh = compat_make_mesh((2, 4), ("data", "model"))
        w = {k: place(v, mesh, param_spec("moe/" + k, v.shape, mesh))
             for k, v in d["w"].items()}
        p = MoELayerParams(router=place(d["router"], mesh, ()), **w)
        x = place(d["x"], mesh, batch_spec(mesh, None, None))
        y, lb, z = moe_block(x, p, cfg, mesh, 4)
        a, b = d["y1"], y.full_tensor().numpy()
        rel = np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-6)
        assert rel < 1e-3, rel
        # aux losses aggregate per data shard (nonlinear in the routing
        # stats), so sharded != global exactly; sanity-range only
        lb4 = float(lb.full_tensor())
        assert 0.5 < lb4 / d["lb1"] < 2.0, (d["lb1"], lb4)
        if RANK == 0:
            print("OK moe ep==local", rel)
    """)
    assert "OK moe ep==local" in out


def test_production_mesh_constructs(one_rank_group):
    """The (16, 16) and (2, 16, 16) meshes on the fake backend (a process
    group of 256 / 512 ranks that runs no collective), and the count a
    group of the wrong size reports."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    m2 = make_production_mesh(multi_pod=True)
    assert dict(zip(m2.mesh_dim_names, m2.shape)) == {
        "pod": 2, "data": 16, "model": 16}
    with pytest.raises(ValueError, match="512"):
        make_production_mesh()
    dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=5,
                            world_size=256)
    m1 = make_production_mesh()
    assert dict(zip(m1.mesh_dim_names, m1.shape)) == {"data": 16,
                                                      "model": 16}
    assert tuple(m1.get_coordinate()) == (0, 5)


def _cnn_case():
    """The reference's mnist-cnn graph and its ``JaxWriter.build()``; the
    weights and input go to the ranks."""
    params = {k: np.asarray(v) for k, v in
              j_cnn.init_params(J_CNN, jax.random.PRNGKey(0)).items()}
    g = JPassManager(j_structural()).run(j_cnn_to_ir(J_CNN, params))
    ref = JaxWriter(g).build()
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (8, 28, 28, 1)))
    return params, x, ref


RANK_CNN = """
from repro_torch.configs.mnist_cnn import CONFIG as CNN
from repro_torch.core.passes import PassManager, structural_pipeline
from repro_torch.core.reader import cnn_to_ir
from repro_torch.core.writers.dist_writer import DistWriter
from repro_torch.launch.mesh import compat_make_mesh
d = torch.load(os.path.join(DATA, "in.pt"), weights_only=False)
g = PassManager(structural_pipeline()).run(cnn_to_ir(CNN, d["params"]))
mesh = compat_make_mesh((4,), ("data",))
w = DistWriter(g, device="cpu")
x = torch.from_numpy(d["x"])
"""


def test_dist_batched_executable_serves_indivisible_batches(tmp_path):
    """One DistWriter artifact on a 4-way data mesh serves batch 8 (sharded
    evenly), 3 and 1 (zero-padded to the DP multiple, output sliced back),
    each within 1e-5 of the reference's ``JaxWriter.build()``."""
    params, x, ref = _cnn_case()
    torch.save({"params": params, "x": x,
                "ref": {b: np.asarray(ref(x[:b])) for b in (8, 3, 1)}},
               tmp_path / "in.pt")
    out = _run_ranks(tmp_path, 4, RANK_CNN + textwrap.dedent("""
        exe = w.build_batched(mesh)
        for b in (8, 3, 1):
            y = exe(x[:b])
            assert type(y) is torch.Tensor and y.shape == (b, 10), y.shape
            np.testing.assert_allclose(y.numpy(), d["ref"][b], atol=1e-5)
        assert exe.cached_batches == (8, 3, 1)
        # symbolic graphs refuse lowering without a concrete batch
        try:
            w.lower_compile(mesh)
        except ValueError as e:
            assert "symbolic" in str(e)
        else:
            raise AssertionError("lower_compile should require batch=")
        sig, fn = w.lower_compile(mesh, batch=4)
        assert sig[0][0] == (4, 28, 28, 1)
        if RANK == 0:
            print("OK dist batched")
    """))
    assert "OK dist batched" in out


def test_accel_server_coalesces_onto_mesh(tmp_path):
    """``AccelServer`` drives ``DistWriter.build_batched`` on a 4-way data
    mesh: mixed-size requests are packed, executed SPMD and demuxed back,
    each within 1e-5 of the reference's per-request result."""
    params, x, ref = _cnn_case()
    sizes = (2, 3, 1, 4, 2)
    torch.save({"params": params, "x": x, "sizes": sizes,
                "ref": [np.asarray(ref(x[:s])) for s in sizes]},
               tmp_path / "in.pt")
    out = _run_ranks(tmp_path, 4, RANK_CNN + textwrap.dedent("""
        from repro_torch.runtime.serve import AccelServer
        traced = []
        srv = AccelServer(w.build_batched(mesh, on_compile=traced.append),
                          max_batch=8, max_wait=0.0)
        tickets = [srv.submit(x[:s]) for s in d["sizes"]]
        srv.pump(flush=True)
        for t, want in zip(tickets, d["ref"]):
            np.testing.assert_allclose(np.asarray(srv.result(t)), want,
                                       atol=1e-5)
        stats = srv.stats()
        assert stats["executed_batches"] < len(d["sizes"])  # coalesced
        assert len(traced) == stats["misses"]   # the hook saw every miss
        if RANK == 0:
            print("OK accel server on mesh")
    """))
    assert "OK accel server on mesh" in out


# ---------------------------------------------------------------------------
# the port's own mesh paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_ssm_prefill_on_mesh_matches_one_device(tmp_path, arch):
    """The f32 smoke prefill on a 2x3 mesh (``make_prefill_step(mesh=)``,
    parameters placed by ``param_sharding``) == the one-device prefill
    within 1e-5 of its max |logit|.  Three model ranks do not divide the 8
    SSD heads (nor hymba's 4 attention and 2 kv heads): the scan runs on
    the heads padded to 9, 3 a rank.  Then one
    ``make_decode_step(mesh=)`` from a state placed by
    ``decode_state_shardings``: logits and the new state within 1e-5 of
    the one-device step's."""
    out = _run_ranks(tmp_path, 6, f"""
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import compat_make_mesh
        from repro_torch.models.params import init_params
        from repro_torch.runtime.serve import make_prefill_step
        from repro_torch.sharding import batch_spec, param_sharding, place, place_tree
        cfg = dataclasses.replace(get_config("{arch}").smoke(),
                                  dtype="float32")
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             max_seq=64, device="cpu")
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab, (2, 64)))
        with torch.no_grad():
            want = make_prefill_step(cfg)(params, {{"tokens": toks}})
            mesh = compat_make_mesh((2, 3), ("data", "model"))
            dp = place_tree(params, param_sharding(params, mesh))
            got = make_prefill_step(cfg, mesh=mesh)(
                dp, {{"tokens": place(toks, mesh, batch_spec(mesh, None))}})
        full = got.full_tensor()
        err = float((full - want).abs().max())
        scale = float(want.abs().max())
        assert err <= 1e-5 * scale, (err, scale)
        # one decode step on the mesh from a state placed by
        # decode_state_shardings, against the one-device step
        from repro_torch.runtime import model_api
        from repro_torch.runtime.serve import (decode_state_shardings,
                                               make_decode_step)
        with torch.no_grad():
            st = model_api.init_decode_state(params, {{}}, cfg, 2, 16,
                                             torch.float32)
            want_d, want_st = make_decode_step(cfg)(params, toks[:, :1], st)
            dst = place_tree(st, decode_state_shardings(cfg, st, mesh))
            got_d, got_st = make_decode_step(cfg, mesh=mesh)(
                dp, place(toks[:, :1], mesh, batch_spec(mesh, None)), dst)
        d_err = float((got_d.full_tensor() - want_d).abs().max())
        assert d_err <= 1e-5 * float(want_d.abs().max()), d_err
        assert got_st.index == want_st.index == 1
        for g, w in zip(got_st[:-1], want_st[:-1]):
            if w is not None:
                assert float((g.full_tensor() - w).abs().max()) <= 1e-5 * (
                    float(w.abs().max()) + 1e-6)
        if RANK == 0:
            print("OK ssm mesh prefill", err, scale, d_err)
    """)
    assert "OK ssm mesh prefill" in out


def test_checkpoint_restores_onto_placements(tmp_path):
    """A checkpoint written on one device (bf16, f32 and int32 leaves)
    restores onto a 2x2 mesh with the given placements on every rank, the
    global tensors bit for bit the saved ones: sharded on one mesh dim,
    on both over one tensor dim (7 rows in pieces of 2, 2, 2, 1), on two
    tensor dims unevenly, and replicated.  Saved again from the mesh
    (``save`` and ``AsyncCheckpointer``), it reads back the same; only
    rank 0 holds host copies (``_host`` gives None elsewhere), and each
    rank's shard box is DTensor's own."""
    from repro_torch.ckpt import checkpoint as ckpt
    g = torch.Generator().manual_seed(4)
    tree = {"params": {"w": torch.randn((4, 6), generator=g).to(
                           torch.bfloat16),
                       "b": torch.randn((6,), generator=g),
                       "u": torch.randn((7, 5), generator=g).to(
                           torch.bfloat16),
                       "v": torch.randn((5, 3), generator=g)},
            "count": {"count": torch.tensor(7, dtype=torch.int32)}}
    ckpt.save(tree, str(tmp_path / "ck"), 3, {"data_step": 3})
    torch.save(tree, tmp_path / "in.pt")
    out = _run_ranks(tmp_path, 4, """
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)
        from repro_torch.ckpt import checkpoint as ckpt
        from repro_torch.launch.mesh import compat_make_mesh
        from repro_torch.sharding import P, NamedSharding
        want = torch.load(os.path.join(DATA, "in.pt"))
        mesh = compat_make_mesh((2, 2), ("data", "model"))
        sh = {"params": {"w": NamedSharding(mesh, P(None, "model")),
                         "b": NamedSharding(mesh, P("model")),
                         "u": NamedSharding(mesh, P(("data", "model"), None)),
                         "v": NamedSharding(mesh, P("model", "data"))},
              "count": {"count": NamedSharding(mesh, P())}}
        tree, step, extra = ckpt.restore(os.path.join(DATA, "ck"), None, sh)
        assert step == 3 and extra == {"data_step": 3}
        for part in want:
            for k, v in want[part].items():
                got = tree[part][k]
                assert tuple(got.placements) == sh[part][k].placements, k
                off, size = ckpt._local_box(v.shape, mesh.shape,
                                            got.placements,
                                            mesh.get_coordinate())
                assert (tuple(size), tuple(off)) == \
                    compute_local_shape_and_global_offset(
                        v.shape, mesh, got.placements), k
                assert tuple(size) == tuple(got.to_local().shape), k
                full = got.full_tensor()
                assert full.dtype == v.dtype and torch.equal(full, v), k
        assert tuple(tree["params"]["u"].to_local().shape) == (
            (2, 5) if RANK < 3 else (1, 5))
        host = ckpt._host(tree)
        assert (host is None) == (RANK != 0)
        # saved back from the mesh by every rank (rank 0 writes; the save
        # and the async writer's wait end in a barrier), read by every rank
        ckpt.save(tree, os.path.join(DATA, "ck2"), 4)
        saver = ckpt.AsyncCheckpointer(os.path.join(DATA, "ck3"))
        saver.save(tree, 5, {"data_step": 5})
        saver.wait()
        for d, n in (("ck2", 4), ("ck3", 5)):
            back, step, _ = ckpt.restore(os.path.join(DATA, d))
            assert step == n
            for part in want:
                for k, v in want[part].items():
                    assert back[part][k].dtype == v.dtype, (d, k)
                    assert torch.equal(back[part][k], v), (d, k)
        if RANK == 0:
            print("OK restore onto placements")
    """)
    assert "OK restore onto placements" in out


def test_local_mesh_needs_cuda_unless_asked_for_the_cpu(one_rank_group,
                                                       monkeypatch):
    """``make_local_mesh()`` resolves its device as every entry point of
    the port does: the CUDA device by default, so without CUDA it raises
    and starts no group; ``device="cpu"`` gives a gloo (1, 1) mesh on the
    CPU, and asking for CUDA then does not reuse that group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_local_mesh()
    assert not dist.is_initialized()
    mesh = make_local_mesh(device="cpu")
    assert mesh.device_type == "cpu" and dist.get_backend() == "gloo"
    assert tuple(mesh.shape) == (1, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="not cuda"):
        make_local_mesh()


def test_ssd_scan_entry_points_refuse_dtensors(one_rank_group):
    """A DTensor reaching the scan's ctypes entry points raises
    ``TypeError`` (the model hands them local shards); ``make_local_mesh``
    starts its own one-rank group: (1, 1) here."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    mesh = make_local_mesh(device="cpu")
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"data": 1,
                                                          "model": 1}
    g = torch.Generator().manual_seed(0)
    B, S, H, Pd, N = 1, 8, 2, 4, 4

    def dt(*shape):
        return distribute_tensor(torch.randn(shape, generator=g), mesh,
                                 [Replicate(), Replicate()])

    x, dtt, A = dt(B, S, H, Pd), dt(B, S, H), dt(H)
    Bm, C, D = dt(B, S, 1, N), dt(B, S, 1, N), dt(H)
    states, decay = dt(B, H, 2, N, Pd), dt(B, H, 2)
    for call in (lambda: ssd_ops.ssd_chunked_kernel(x, dtt, A, Bm, C, D, 4),
                 lambda: ssd_ops.ssd_scan_cuda(x, dtt, A, Bm, C, D, 4),
                 lambda: ssd_ops.ssd_chunk_state_cuda(x, dtt, A, Bm, 4),
                 lambda: ssd_ops.ssd_state_pass_cuda(states, decay),
                 lambda: ssd_ops.ssd_chunk_scan_cuda(x, dtt, A, Bm, C, D,
                                                     states, 4),
                 lambda: ssd_ops.ssd_chunk_states(x, dtt, A, Bm, 4),
                 lambda: ssd_ops.ssd_state_pass(states, decay),
                 lambda: ssd_ops.ssd_chunk_scan(x, dtt, A, Bm, C, D, states,
                                                4)):
        with pytest.raises(TypeError, match="DTensor"):
            call()
