"""Writer 1: IR -> PyTorch callable, the float reference target ``"torch"``
(counterpart of ``repro.core.writers.jax_writer``).

Faithful to the paper's HLS flow semantics: weights are fake-quantized to Wy
at build time and the activation stream is quantized to Dx at every actor
boundary; ``capture=True`` also returns every intermediate tensor (PTQ
calibration).  Precision is per layer (``Node.dtconfig``), actor impls come
from the target-keyed op registry, and every executable runs on the writer's
device: it takes host arrays or tensors, moves them there, and returns
device tensors.

``build_batched`` wraps the interpreter in a :class:`BatchedExecutable` with
the reference's interface (per-signature LRU, hit/miss telemetry,
``cached_batches``/``has_batch`` for the scheduler's bucket policy,
``on_compile``, ``bits``).  PyTorch runs eagerly, so a miss compiles nothing;
the bookkeeping stays honest all the same — a miss is the first call at a
signature.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.ir import Graph, Node
from repro_torch.core.writers.registry import resolve
from repro_torch.device import DeviceLike, as_tensor, resolve_device
from repro_torch.quant.fixedpoint import fake_quant
from repro_torch.quant.ptq import effective_weight_dt, weight_qtype
from repro_torch.quant.qtypes import DatatypeConfig, fixed_for_range

Signature = Tuple[Tuple[Tuple[int, ...], str], ...]


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


class BatchedExecutable:
    """Batch-polymorphic artifact: dispatches on the concrete input signature
    (shapes + dtypes) and keeps at most ``max_entries`` signatures in an LRU.
    PyTorch runs eagerly, so without ``compile_fn`` every signature runs the
    same interpreter; the LRU is the serving bookkeeping the scheduler's
    bucket policy reads.  ``compile_fn(signature)``, called on a miss,
    returns the callable that signature runs (the distributed writer's
    per-batch padded SPMD runner); ``fn`` may then be None."""

    def __init__(self, fn: Optional[Callable], max_entries: int = 8,
                 compile_fn: Optional[Callable[[Signature], Callable]] = None,
                 on_compile: Optional[Callable[[Signature], None]] = None,
                 bits: Optional[int] = None):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        if fn is None and compile_fn is None:
            raise ValueError("BatchedExecutable needs fn or compile_fn")
        self._compile = compile_fn or (lambda sig: fn)
        self._cache: "OrderedDict[Signature, Callable]" = OrderedDict()
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        # serving telemetry hook: called with the signature on every miss
        self.on_compile = on_compile
        # weight working point this artifact executes at
        self.bits = bits

    @staticmethod
    def signature(*inputs) -> Signature:
        return tuple((tuple(int(d) for d in x.shape), _dtype_name(x))
                     for x in inputs)

    def executable_for(self, *inputs) -> Callable:
        sig = self.signature(*inputs)
        exe = self._cache.get(sig)
        if exe is None:
            self.misses += 1
            if self.on_compile is not None:
                self.on_compile(sig)
            exe = self._compile(sig)
            self._cache[sig] = exe
            while len(self._cache) > self.max_entries:
                self._cache.popitem(last=False)
        else:
            self.hits += 1
            self._cache.move_to_end(sig)
        return exe

    def __call__(self, *inputs):
        return self.executable_for(*inputs)(*inputs)

    @property
    def cached_signatures(self) -> Tuple[Signature, ...]:
        return tuple(self._cache)

    @property
    def cached_batches(self) -> Tuple[int, ...]:
        """Leading-dim sizes currently resident (serving telemetry)."""
        return tuple(sig[0][0][0] for sig in self._cache if sig and sig[0][0])

    def has_batch(self, batch: int) -> bool:
        """True when this leading-dim size is resident — the scheduler's
        bucket policy prefers such sizes."""
        return batch in self.cached_batches

    def telemetry(self) -> Dict[str, Any]:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "cached_batches": self.cached_batches,
            "capacity": self.max_entries,
            "bits": self.bits,
        }


class TorchWriter:
    """Builds an executable from the (pass-annotated) IR on ``device``
    (default ``"cuda"``; pass ``"cpu"`` for the CPU)."""

    target = "torch"

    def __init__(self, graph: Graph,
                 dtconfig: Optional[DatatypeConfig] = None,
                 act_ranges: Optional[Dict[str, float]] = None, *,
                 device: DeviceLike = None):
        graph.validate()
        self.graph = graph
        self.device = resolve_device(device)
        self.dt = dtconfig or DatatypeConfig(32, 32)
        self.act_ranges = act_ranges or {}
        # output names whose activation quant an op impl already applied in
        # its fused epilogue — _act_q skips them instead of re-rounding
        self._fused_act: set = set()
        self.weights = self._prepare_weights()

    def node_dt(self, node: Optional[Node]) -> DatatypeConfig:
        if node is not None and node.dtconfig is not None:
            return node.dtconfig
        return self.dt

    def _prepare_weights(self) -> Dict[str, Any]:
        """Fake-quantize each initializer at its consumer's weight precision
        (per-layer Wy); 1-D tensors pass through in float."""
        out = {}
        for name, w in self.graph.initializers.items():
            w = as_tensor(w, self.device)
            dt = effective_weight_dt(self.graph, name, self.dt)
            if dt.weight_bits < 32 and w.ndim >= 2:
                out[name] = fake_quant(w, weight_qtype(w, dt.weight_bits))
            else:
                out[name] = w
        return out

    def op_impl(self, op: str) -> Callable:
        return resolve(op, self.target)

    def _act_q(self, name: str, x, node: Optional[Node] = None):
        if name in self._fused_act:
            return x
        bits = self.node_dt(node).act_bits
        if bits >= 32 or not torch.is_floating_point(x):
            return x
        qt = fixed_for_range(bits, self.act_ranges.get(name, 8.0))
        return fake_quant(x, qt)

    def _materialize(self, value):
        """Hook: convert one graph *output* to its caller-facing form."""
        return value

    def _env_seed(self, bits: Optional[int] = None) -> Dict[str, Any]:
        if bits is not None:
            raise ValueError(
                f"writer target {self.target!r} bakes weight precision at "
                "build; bits= is a parameter of packed-weight writers "
                "(target 'qtorch')")
        return self.weights

    def build(self, capture: bool = False,
              bits: Optional[int] = None) -> Callable:
        order = self.graph.topo_order()
        in_names = [t.name for t in self.graph.inputs]
        impls = [(node, self.op_impl(node.op)) for node in order]
        seed = self._env_seed(bits)
        device = self.device

        def run(*inputs):
            env: Dict[str, Any] = dict(seed)
            for n, x in zip(in_names, inputs):
                env[n] = self._act_q(n, as_tensor(x, device))
            for node, impl in impls:
                y = impl(node, env)
                outs = y if isinstance(y, tuple) else (y,)
                for oname, oval in zip(node.outputs, outs):
                    env[oname] = self._act_q(oname, oval, node)
            outs = tuple(self._materialize(env[o]) for o in self.graph.outputs)
            if capture:
                return outs[0] if len(outs) == 1 else outs, env
            return outs[0] if len(outs) == 1 else outs

        return run

    def build_batched(self, max_entries: int = 8,
                      on_compile: Optional[Callable] = None,
                      bits: Optional[int] = None) -> BatchedExecutable:
        """Batch-polymorphic executable (see :class:`BatchedExecutable`)."""
        return BatchedExecutable(self.build(bits=bits), max_entries=max_entries,
                                 on_compile=on_compile, bits=bits)


def float_reference(graph: Graph, calib_inputs, device: DeviceLike = None
                    ) -> Tuple[Any, Dict[str, float]]:
    """One run of the float reference on the calibration inputs: (its
    outputs, the max |x| of every floating tensor it saw) — the ranges the
    quantizing writers turn into fixed-point and power-of-two code scales."""
    out, env = TorchWriter(graph, device=device).build(capture=True)(
        *calib_inputs)
    return out, {k: float(v.abs().max()) for k, v in env.items()
                 if isinstance(v, torch.Tensor) and torch.is_floating_point(v)}
