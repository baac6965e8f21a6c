"""ONNX-like graph IR — the ONNXParser intermediate format (counterpart of
``repro.core.ir``; numpy only, shared verbatim in behaviour).

The paper's Reader produces "an intermediate format with a list of objects
that describes layers and connections of the ONNX model"; this module is that
format.  Op semantics follow ONNX operator definitions.  The ``onnx`` package
is unavailable offline, so serialization is ONNX-shaped JSON (graph topology +
tensor metadata) with weights in an ``.npz`` sidecar.

The IR carries two kinds of per-graph annotations written by the compiler
passes in :mod:`repro_torch.core.passes`:

* ``Graph.value_info`` — a ``tensor name -> TensorInfo`` map filled in by the
  shape-inference pass; every FIFO between actors gets a static shape/dtype.
* ``Node.dtconfig`` — an optional per-layer :class:`~repro_torch.quant.qtypes.
  DatatypeConfig` attached by the precision-assignment pass.  Writers fall
  back to their construction-time default when a node carries no annotation,
  so un-annotated graphs behave exactly like the old single-global-config
  flow.

Graphs also maintain O(V+E) structural indices (``producer_index`` /
``consumer_index``) used by ``topo_order``, the passes, and the writers.

Shapes may carry ONE symbolic dimension — the leading (batch) dim, written
``BATCH`` (the string ``"N"``).  A graph whose input batch is symbolic
compiles to a *batch-polymorphic* executable: the writers trace/jit per
concrete batch size on demand (LRU of traced shapes) instead of baking a
literal batch into the artifact.  All non-leading dims stay concrete ints,
which is what the streaming FIFO-sizing model requires (per-row volumes
never involve the batch dim).
"""
from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass, field, asdict
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.quant.qtypes import DatatypeConfig

# Symbolic leading-dimension sentinel.  ``TensorInfo.shape`` entries are ints
# except (at most) the leading dim, which may be this marker.
BATCH = "N"

Dim = Union[int, str]


def is_symbolic(dim: Dim) -> bool:
    """True for the symbolic batch marker (any string dim)."""
    return isinstance(dim, str)


def has_symbolic(shape) -> bool:
    return any(is_symbolic(d) for d in shape)


def concretize(shape, batch: int) -> Tuple[int, ...]:
    """Substitute a concrete batch size for every symbolic dim."""
    return tuple(int(batch) if is_symbolic(d) else int(d) for d in shape)


def static_elems(shape) -> int:
    """Element count of the non-symbolic dims (per-item volume for a
    batch-leading tensor) — what FIFO sizing and weight-storage math use."""
    n = 1
    for d in shape:
        if not is_symbolic(d):
            n *= int(d)
    return n


SUPPORTED_OPS = {
    "Conv", "MaxPool", "BatchNormalization", "Relu", "Gemm", "MatMul",
    "Add", "Flatten", "Softmax", "Reshape", "Identity", "Split",
    # grouped Conv with group == channels and HWIO weights (kh, kw, 1, C);
    # produced directly by readers or by normalize_groups from an ONNX Conv
    # carrying a depthwise ``group`` attribute
    "DepthwiseConv",
    # produced by the fusion pass: Conv with folded BatchNormalization
    # (+ optional trailing Relu, attrs["relu"]=True)
    "FusedConv",
    # produced by the fusion pass: DepthwiseConv with folded BN (+ Relu)
    "FusedDepthwiseConv",
    # produced by the fusion pass: Gemm with a folded trailing Relu
    "FusedGemm",
}


@dataclass
class TensorInfo:
    name: str
    shape: Tuple[Dim, ...]     # leading dim may be the symbolic BATCH marker
    dtype: str = "float32"

    @property
    def is_batched(self) -> bool:
        return has_symbolic(self.shape)

    def concrete(self, batch: int) -> Tuple[int, ...]:
        return concretize(self.shape, batch)


@dataclass
class Node:
    op: str
    name: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any] = field(default_factory=dict)
    # per-layer precision annotation (written by the precision pass);
    # None => use the writer's default DatatypeConfig
    dtconfig: Optional[DatatypeConfig] = None

    def __post_init__(self):
        if self.op not in SUPPORTED_OPS:
            raise ValueError(f"unsupported op {self.op!r} (node {self.name})")


@dataclass
class Graph:
    name: str
    nodes: List[Node]
    inputs: List[TensorInfo]
    outputs: List[str]
    initializers: Dict[str, np.ndarray] = field(default_factory=dict)
    # tensor name -> inferred TensorInfo (filled by the shape-inference pass)
    value_info: Dict[str, TensorInfo] = field(default_factory=dict)

    # ---- validation / ordering -------------------------------------------
    def validate(self) -> None:
        produced = {t.name for t in self.inputs} | set(self.initializers)
        names = set()
        for n in self.nodes:
            if n.name in names:
                raise ValueError(f"duplicate node name {n.name}")
            names.add(n.name)
        for n in self.topo_order():
            for i in n.inputs:
                if i not in produced:
                    raise ValueError(f"node {n.name}: undefined input {i!r}")
            produced.update(n.outputs)
        for o in self.outputs:
            if o not in produced:
                raise ValueError(f"undefined graph output {o!r}")

    # ---- structural indices (O(V+E), cached per node-list identity) -------
    def _index_key(self) -> Tuple[int, ...]:
        return tuple(id(n) for n in self.nodes)

    def producer_index(self) -> Dict[str, Node]:
        """tensor name -> producing Node, built once in O(V+E)."""
        cached = self.__dict__.get("_pidx")
        key = self._index_key()
        if cached is None or cached[0] != key:
            idx: Dict[str, Node] = {}
            for n in self.nodes:
                for o in n.outputs:
                    idx[o] = n
            self.__dict__["_pidx"] = cached = (key, idx)
        return cached[1]

    def consumer_index(self) -> Dict[str, List[Node]]:
        """tensor name -> consuming Nodes, built once in O(V+E)."""
        cached = self.__dict__.get("_cidx")
        key = self._index_key()
        if cached is None or cached[0] != key:
            idx: Dict[str, List[Node]] = {}
            for n in self.nodes:
                for i in n.inputs:
                    idx.setdefault(i, []).append(n)
            self.__dict__["_cidx"] = cached = (key, idx)
        return cached[1]

    def topo_order(self) -> List[Node]:
        """Kahn's algorithm over the producer index — O(V+E) (the old
        implementation re-scanned the remaining-node list per step, O(V^2·E)
        worst case)."""
        avail = {t.name for t in self.inputs} | set(self.initializers)
        producers: Dict[str, int] = {}
        for idx, n in enumerate(self.nodes):
            for o in n.outputs:
                producers[o] = idx
        indeg = [0] * len(self.nodes)
        adj: Dict[int, List[int]] = {}
        for idx, n in enumerate(self.nodes):
            for i in set(n.inputs):
                if i in avail:
                    continue
                p = producers.get(i)
                indeg[idx] += 1
                if p is not None and p != idx:
                    adj.setdefault(p, []).append(idx)
                # p is None (missing producer) or a self-loop: the edge can
                # never be satisfied, so the node stays unscheduled and we
                # report it below.
        ready = deque(i for i, d in enumerate(indeg) if d == 0)
        order: List[Node] = []
        while ready:
            idx = ready.popleft()
            order.append(self.nodes[idx])
            for c in adj.get(idx, ()):
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(order) != len(self.nodes):
            stuck = [n.name for i, n in enumerate(self.nodes) if indeg[i] > 0]
            raise ValueError(
                f"graph has a cycle or missing producer; stuck at {stuck}")
        return order

    def producer_of(self, tensor: str) -> Optional[Node]:
        return self.producer_index().get(tensor)

    def consumers_of(self, tensor: str) -> List[Node]:
        return self.consumer_index().get(tensor, [])

    # ---- serialization ----------------------------------------------------
    def to_json(self) -> str:
        d = {
            "name": self.name,
            "nodes": [asdict(n) for n in self.nodes],
            "inputs": [asdict(t) for t in self.inputs],
            "outputs": self.outputs,
            "initializers": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                             for k, v in self.initializers.items()},
            "value_info": {k: {"shape": list(t.shape), "dtype": t.dtype}
                           for k, t in self.value_info.items()},
        }
        return json.dumps(d, indent=1)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
        if self.initializers:
            np.savez(path + ".npz", **self.initializers)

    @classmethod
    def from_json(cls, text: str, weights: Optional[Dict[str, np.ndarray]] = None
                  ) -> "Graph":
        d = json.loads(text)
        nodes = []
        for n in d["nodes"]:
            n = dict(n)
            dt = n.pop("dtconfig", None)
            node = Node(**n)
            if dt is not None:
                node.dtconfig = DatatypeConfig(**dt)
            nodes.append(node)
        inputs = [TensorInfo(t["name"], tuple(t["shape"]), t.get("dtype", "float32"))
                  for t in d["inputs"]]
        inits = dict(weights or {})
        for k, meta in d.get("initializers", {}).items():
            if k not in inits:
                inits[k] = np.zeros(meta["shape"], dtype=meta["dtype"])
        vi = {k: TensorInfo(k, tuple(m["shape"]), m.get("dtype", "float32"))
              for k, m in d.get("value_info", {}).items()}
        g = cls(d["name"], nodes, inputs, d["outputs"], inits, vi)
        g.validate()
        return g

    @classmethod
    def load(cls, path: str) -> "Graph":
        import os
        weights = None
        if os.path.exists(path + ".npz"):
            weights = dict(np.load(path + ".npz"))
        with open(path) as f:
            return cls.from_json(f.read(), weights)
