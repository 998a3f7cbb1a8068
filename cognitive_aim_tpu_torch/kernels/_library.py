"""How a kernel reaches PyTorch: one custom op of the namespace ``caim`` each.

Every kernel wrapper of this package calls a ``torch.library`` custom op,
registered here by ``kernel_op`` when its module is imported (importing
``cognitive_aim_tpu_torch.kernels`` imports them all):

  * the op's implementation is the wrapper's body: CPU tensors run the
    plain PyTorch version; CUDA tensors pass the kernel's checks and launch
    it through the library's C entry (``_build``, ctypes on ``data_ptr()``),
    or raise. It adds one to the wrapper's ``launches`` where it launches,
    so a program loaded from a ``torch.export`` artifact counts too;
  * the op's fake gives the outputs' shapes and dtypes, contiguous, as the
    implementation returns them. It never builds or loads the library,
    never reads a pointer and checks nothing the CPU path does not;
  * no output aliases an input or another output.

So a traced graph (``torch.export``) holds one ``caim.<op>`` node a launch
where it used to trace the plain versions' arithmetic, and a loaded program
needs these registrations and nothing of the model's modules. The ops have
no autograd formula: the differentiable wrappers call theirs inside
``_grad.recompute_vjp``'s forward, the others raise under grad first
(``_grad.forbid_grad``).
"""

from __future__ import annotations

import collections
from typing import Callable, Dict

import torch

NAMESPACE = "caim"
OPS: Dict[str, "torch._library.custom_ops.CustomOpDef"] = {}  # op name -> op


def kernel_op(name: str, fake: Callable):
    """Decorator: register ``impl`` as the op ``caim::<name>`` (its schema
    from ``impl``'s annotations) with ``fake`` as its fake; returns the op,
    which is called as ``impl`` is."""
    def register(impl: Callable):
        op = torch.library.custom_op(f"{NAMESPACE}::{name}", impl, mutates_args=())
        op.register_fake(fake)
        OPS[name] = op
        return op
    return register


def op_counts(graph) -> collections.Counter:
    """``caim`` op name -> its nodes in ``graph`` (a ``torch.fx.Graph``, a
    GraphModule or an ExportedProgram)."""
    graph = getattr(graph, "graph", graph)
    return collections.Counter(
        n.target._opname for n in graph.nodes
        if n.op == "call_function" and isinstance(n.target, torch._ops.OpOverload)
        and n.target.namespace == NAMESPACE)
