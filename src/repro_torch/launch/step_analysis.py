"""What one rank does in a step: its collectives, its dot FLOPs, the
bytes its ops touch and the memory it holds (the port's counterpart of
``repro.launch.hlo_analysis``).

The JAX package reads these off the per-device HLO.  The port has no
HLO: :class:`StepCounter` is a dispatch mode that sees every aten op a
rank runs on its *local* tensors while the step runs (``meta`` shards
on a fake mesh for the dry run, or real ranks).
Like ``distributed.runtime.Collectives`` it returns ``NotImplemented``
for DTensor (and funcol wrapper) ops, so DTensor runs first and its local
ops and collectives come back through the mode: a mode that counted
above DTensor would see the global shapes, and its FLOPs would be the
whole mesh's.  DTensor's sharding propagation runs each op it has not
seen before once more on fake tensors of the *global* shapes, to learn
the output's shape: the counter pauses while it does.

* :func:`collective_totals`: calls and **result** bytes by HLO kind
  (``all-gather``, ``reduce-scatter``, ``all-reduce``, ``all-to-all``),
  as ``hlo_analysis.collective_totals`` counts them, and the bytes sent
  in (``sent_bytes_by_op``), counted by ``runtime.CollectiveCount`` as
  the real ranks' ``runtime.Collectives`` counts them.
* :func:`compute_totals`: the FLOPs of every product op that
  ``torch.utils.flop_counter`` has a formula for (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``; the models have no convolutions), and a proxy
  for the bytes accessed.  Eager PyTorch runs every layer and microbatch
  in full, so the trip-count walk of the HLO has no counterpart: the
  record's ``flops_per_device`` equals its ``hlo_flops_per_device``.
  The bytes proxy charges the operands and the result of every op that
  is not a view.  Eager PyTorch fuses nothing, so it is an upper bound on
  what the step moves, where XLA's (which charges fusions, not their
  inner ops) is not.
* :func:`memory`: the bytes of the step's arguments and outputs, the
  output bytes that share storage with an argument (the parameters and
  moments updated in place, the counterpart of donated buffers:
  ``alias_bytes``), and the peak of the storages the step allocates
  while it runs (``temp_bytes``).
"""

from __future__ import annotations

import collections
import weakref
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.distributed._functional_collectives import AsyncCollectiveTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import runtime

_WRAPPERS = (DTensor, AsyncCollectiveTensor)
# DTensor's sharding propagation, cached and not
_PROPAGATE = ("propagate_op_sharding", "propagate_op_sharding_non_cached")
_nbytes = runtime._nbytes


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor; a plain tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


class StepCounter(TorchDispatchMode, runtime.CollectiveCount):
    """Counts the local ops a rank runs inside the block (see the module
    docstring), its collectives as ``runtime.CollectiveCount`` does.
    ``where`` (optional) names the code that issued a collective; each
    one's result bytes are then also summed under ``(kind, where())`` in
    ``by_source``."""

    def __init__(self, where: Optional[Callable[[], str]] = None):
        super().__init__()
        self.reset()
        self.where = where
        self.by_source: Dict[tuple, int] = collections.Counter()
        self.flops = 0
        self.flops_by_op: Dict[str, int] = collections.Counter()
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self._known: "weakref.WeakSet" = weakref.WeakSet()
        self._paused = 0

    def _paused_in(self, fn: Callable) -> Callable:
        def run(*args, **kwargs):
            self._paused += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._paused -= 1
        return run

    def __enter__(self):
        prop = DTensor._op_dispatcher.sharding_propagator
        self._saved = {n: prop.__dict__.get(n) for n in _PROPAGATE}
        for n in _PROPAGATE:
            setattr(prop, n, self._paused_in(getattr(prop, n)))
        return super().__enter__()

    def __exit__(self, *exc):
        prop = DTensor._op_dispatcher.sharding_propagator
        for n, fn in self._saved.items():
            if fn is None:
                delattr(prop, n)
            else:
                setattr(prop, n, fn)
        return super().__exit__(*exc)

    def track(self, tree: Any) -> None:
        """Count the storages of the tensors in ``tree`` as held already
        (the step's arguments): the step neither allocates nor frees
        them."""
        for t in _tensors(tree):
            self._known.add(local(t).untyped_storage())

    def _allocated(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._known:
            return
        self._known.add(st)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._freed, n)

    def _freed(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, _WRAPPERS) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        outs = _tensors(out)
        for t in outs:
            self._allocated(t)
        if func.namespace == "_c10d_functional":
            name = func.__name__.split(".")[0]
            if name in runtime.LOCAL_OPS:
                return out
            kind = self.add(name, args[0], out)
            if self.where is not None:
                self.by_source[(kind, self.where())] += _nbytes(out)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            n = int(formula(*args, **kwargs, out_val=out))
            self.flops += n
            self.flops_by_op[func._overloadpacket.__name__] += n
        if not func.is_view:
            self.bytes_accessed += sum(
                _nbytes(t) for t in _tensors((args, kwargs))) \
                + sum(_nbytes(t) for t in outs)
        return out


def collective_totals(c: runtime.CollectiveCount) -> Dict[str, Any]:
    """``hlo_analysis.collective_totals``' record: result bytes and calls
    by kind, and their total; with the bytes sent in by kind."""
    return c.totals()


def compute_totals(c: StepCounter) -> Dict[str, Any]:
    """``hlo_analysis.compute_totals``' record, with the FLOPs by op."""
    return {"flops": float(c.flops), "bytes_accessed": float(c.bytes_accessed),
            "flops_by_op": dict(c.flops_by_op)}


def memory(c: StepCounter, args: Any, outs: Any) -> Dict[str, int]:
    """The step's memory record (``compiled.memory_analysis()``'s fields):
    the local bytes of ``args`` and of ``outs``, the output bytes whose
    storage is an argument's, and the temp peak the counter saw."""
    def storages(tree):
        seen = {}
        for t in _tensors(tree):
            st = local(t).untyped_storage()
            seen[id(st)] = (st, st.nbytes())
        return seen
    a, o = storages(args), storages(outs)
    return {"argument_bytes": sum(n for _, n in a.values()),
            "output_bytes": sum(n for _, n in o.values()),
            "temp_bytes": c.peak,
            "alias_bytes": sum(n for k, (_, n) in o.items() if k in a)}
