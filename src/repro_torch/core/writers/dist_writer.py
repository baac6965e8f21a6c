"""Writer 3: IR -> SPMD executable on a device mesh (counterpart of
``repro.core.writers.dist_writer``).

The co-processor-generator analogue: wraps the accelerator for a mesh
(batch data-parallel; weights replicated — edge-CNN weights are tiny).
Registers nothing in the op registry: every actor runs the float ("torch")
implementation and only the partitioning changes.  Each rank runs the
interpreter on its own rows of the batch (:func:`repro_torch.sharding.
shard_map`); when the shape-inference pass has annotated the graph, the
output spec replicates the trailing dims explicitly.

PyTorch runs eagerly, so nothing is lowered ahead of time:
``lower_compile`` checks the signature the reference would lower and
returns the callable for it.  A graph whose input leading dim is the
symbolic :data:`repro_torch.core.ir.BATCH` marker needs ``batch=`` there,
as in the reference, and ``build_batched`` keeps an LRU of per-batch
runners so one ``DesignFlow.run`` artifact serves varying request sizes on
the mesh.  Every rank of the mesh makes the same calls (SPMD).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.ir import has_symbolic
from repro_torch.core.writers.torch_writer import BatchedExecutable, TorchWriter
from repro_torch.device import as_tensor
from repro_torch.sharding import (P, batch_axes, dp_size, place, shard_map,
                                  with_global_shape)


class DistWriter(TorchWriter):
    target = "dist"

    def _out_spec(self, dp) -> P:
        info = self.graph.value_info.get(self.graph.outputs[0])
        if info is not None:
            return P(dp, *([None] * (len(info.shape) - 1)))
        return P(dp)

    def build_distributed(self, mesh) -> Callable:
        """-> ``run(*inputs)``: global inputs (the same on every rank) are
        sharded on dim 0 over the data axes, each rank runs the interpreter
        on its rows, and the output is a DTensor placed by ``_out_spec``."""
        run = self.build()
        dp = batch_axes(mesh)
        in_specs = tuple(P(dp, *([None] * (len(t.shape) - 1)))
                         for t in self.graph.inputs)
        out_spec = self._out_spec(dp)
        device = self.device

        def dist_run(*inputs):
            xs = [place(as_tensor(x, device), mesh, s)
                  for x, s in zip(inputs, in_specs)]
            local = {}

            def body(*shards):
                y = run(*shards)
                local["shape"] = tuple(y.shape[1:])
                return y

            out = shard_map(body, mesh, in_specs, out_spec)(*xs)
            # the rows of an uneven batch: the global leading dim is the
            # input's, not the local shard's times the ranks
            return with_global_shape(out, (xs[0].shape[0],) + local["shape"])

        return dist_run

    def lower_compile(self, mesh, batch: Optional[int] = None):
        """-> (input signature, runner): the shapes and dtypes the reference
        would lower at, and :meth:`build_distributed`'s callable."""
        fn = self.build_distributed(mesh)
        args = []
        for t in self.graph.inputs:
            if batch is not None:
                shape = t.concrete(batch) if t.is_batched \
                    else (batch, *t.shape[1:])
            elif has_symbolic(t.shape):
                raise ValueError(
                    f"input {t.name!r} has a symbolic batch dim; pass "
                    "batch= to lower_compile (or use build_batched)")
            else:
                shape = tuple(t.shape)
            args.append((tuple(shape), t.dtype))
        return tuple(args), fn

    def build_batched(self, mesh=None, max_entries: int = 8,
                      on_compile: Optional[Callable] = None
                      ) -> BatchedExecutable:
        """Batch-polymorphic SPMD artifact: an LRU of per-batch runners on
        ``mesh`` (without a mesh, the plain single-device batched
        executable).  Its executables return the global result as a plain
        tensor, as ``np.asarray`` of the reference's global array gives.

        The data axes shard the leading dim, so a request batch that does
        not divide the mesh's DP size is zero-padded up to the next multiple
        and the output sliced back — any batch size serves, at the cost of
        running the padded remainder."""
        if mesh is None:
            return super().build_batched(max_entries=max_entries,
                                         on_compile=on_compile)
        dp = dp_size(mesh)
        device = self.device

        def compile_for(sig):
            batch = sig[0][0][0]
            padded = -(-batch // dp) * dp
            _, fn = self.lower_compile(mesh, batch=padded)

            def run_padded(*inputs):
                xs = [as_tensor(x, device) for x in inputs]
                if padded != batch:
                    xs = [torch.cat([x, x.new_zeros((padded - x.shape[0],
                                                     *x.shape[1:]))])
                          for x in xs]
                out = fn(*xs)
                if isinstance(out, tuple):
                    return tuple(o.full_tensor()[:batch] for o in out)
                return out.full_tensor()[:batch]

            return run_padded

        return BatchedExecutable(None, max_entries=max_entries,
                                 compile_fn=compile_for, on_compile=on_compile)
