"""Model surgery and shape tracing — the reference's modify_model.py tools.

Port of ``cross_attention_vit_tpu/models/surgery.py``.  The reference offers
``get_model_upto_layer`` (rebuild a model truncated at a dotted layer path)
and forward-hook shape printing for every leaf module with
``inspect_model`` (modify_model.py:7-55, 63-125, 163-188).  Here:

    out, records = trace_shapes(model, *inputs)   # (name, shape, dtype) records
    inspect_model(model, *inputs)                 # the same as a printed table

``trace_shapes`` runs the forward on the ``meta`` device: a model made with
``device="meta"`` and inputs made there (``torch.empty(shape,
device="meta")``) carry shapes and dtypes and no data, so the trace computes
nothing and needs no card, as ``jax.eval_shape`` does for the JAX package.
The trace records every torch function the forward calls (``F.linear``,
``torch.matmul``, ``F.conv3d``, ``F.layer_norm``, ...; tensor methods and
views left out) with its output's shape, through a ``TorchFunctionMode`` —
the port's models call their layers' weights through the ops, so a forward
hook on a leaf module would not fire — and, by its dotted name, the output
of every leaf module called as a module (forward hooks), and whatever the
code marks with ``shape_probe``.  A model configured for the flash
kernels cannot be traced there: a kernel has no shape-only mode, so the
trace refuses it (its shapes are those of the same model with
``use_flash_attention=False``).

Truncation is a forward argument (``models.densenet.DenseNet121``'s
``upto=``); ``truncate_apply`` binds it.
"""

from __future__ import annotations

import contextlib
import threading
import types
from collections import defaultdict

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

_local = threading.local()


def shape_probe(name: str, x):
    """Record (name, shape, dtype) of x (a tensor or a sequence of them)
    while a trace is active; returns x."""
    rec = getattr(_local, "records", None)
    if rec is not None:
        for t in (x if isinstance(x, (list, tuple)) else [x]):
            rec.append((name, tuple(t.shape), str(t.dtype).replace("torch.", "")))
    return x


@contextlib.contextmanager
def _tracing():
    _local.records = []
    try:
        yield _local.records
    finally:
        _local.records = None


_METHODS = (types.MethodDescriptorType, types.WrapperDescriptorType,
            types.GetSetDescriptorType)


class _OpTrace(TorchFunctionMode):
    """Records each torch function's tensor output (its nested calls run
    with the mode off, so a layer records once)."""

    def __torch_function__(self, func, types_, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "")
        if isinstance(out, torch.Tensor) and not isinstance(func, _METHODS) \
                and not name.startswith("__"):
            shape_probe(name, out)
        return out


def _shapes(out):
    if isinstance(out, torch.Tensor):
        return tuple(out.shape), str(out.dtype).replace("torch.", "")
    if isinstance(out, (list, tuple)):
        return type(out)(_shapes(o) for o in out)
    return out


def trace_shapes(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` on meta tensors; returns (output shapes,
    records), each record (name, shape, dtype) of a torch function's output
    (by the function's name), of a leaf module called as a module (by its
    dotted name, when ``fn`` is an ``nn.Module``) or of a ``shape_probe``,
    in call order.  Every tensor argument, and the module's parameters, must
    be on the meta device."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if isinstance(fn, torch.nn.Module):
        tensors += list(fn.parameters())
        cfg = getattr(fn, "config", None)
        if cfg is not None and cfg.get("use_flash_attention", False):
            raise ValueError("a model configured for the flash kernels cannot be traced on the "
                             "meta device: trace it with use_flash_attention=False (the shapes "
                             "are the same)")
    if any(t.device.type != "meta" for t in tensors):
        raise ValueError("trace_shapes runs on the meta device: make the model with "
                         "device='meta' and the inputs with torch.empty(..., device='meta')")
    hooks = []
    with _tracing() as records:
        if isinstance(fn, torch.nn.Module):
            for name, mod in fn.named_modules():
                if name and not list(mod.children()):
                    hooks.append(mod.register_forward_hook(
                        lambda m, i, o, name=name: shape_probe(name, o)))
        try:
            with torch.no_grad(), _OpTrace():
                out = fn(*args, **kwargs)
        finally:
            for h in hooks:
                h.remove()
    return _shapes(out), list(records)


def inspect_model(fn, *args, quiet: bool = False, **kwargs) -> str:
    """A shape trace as a printed table (modify_model.py:163-188); never
    touches a device."""
    out_shapes, records = trace_shapes(fn, *args, **kwargs)
    lines = [f"{name:60s} {str(shape):24s} {dtype}" for name, shape, dtype in records]
    lines.append(f"{'-> output':60s} {out_shapes!r}")
    text = "\n".join(lines)
    if not quiet:
        print(text)
    return text


def truncate_apply(apply_fn, upto: str):
    """``apply_fn`` with ``upto=`` bound (get_model_upto_layer), for a
    forward that takes it, such as ``DenseNet121``'s."""

    def truncated(*args, **kwargs):
        return apply_fn(*args, upto=upto, **kwargs)

    truncated.__name__ = f"{getattr(apply_fn, '__name__', 'apply')}__upto__{upto}"
    return truncated


def _leaves(params, path=()):
    """(path, array) of a JAX-layout param tree, or of a module's parameters
    laid out as their JAX tree (``models.convert``), by shape alone: a meta
    model summarises too."""
    if isinstance(params, torch.nn.Module):
        from .convert import jax_params_from_state_dict

        zero = np.zeros((), np.float32)
        sd = {k: np.broadcast_to(zero, tuple(p.shape)) for k, p in params.named_parameters()}
        params = jax_params_from_state_dict(sd, getattr(params, "config", None))
    if isinstance(params, dict):
        for k, v in params.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, params


def param_count(params) -> int:
    """Parameters of a module, or leaves of a param tree, counted."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    return sum(int(np.prod(np.shape(leaf))) for _, leaf in _leaves(params))


def param_summary(params, max_depth: int = 2) -> str:
    """Parameter counts grouped by the first ``max_depth`` parts of their
    JAX-tree path — the JAX package's table for the same weights."""
    groups: dict[str, int] = defaultdict(int)
    for path, leaf in _leaves(params):
        groups["/".join(path[:max_depth])] += int(np.prod(np.shape(leaf)))
    width = max(len(k) for k in groups) if groups else 10
    lines = [f"{k:{width}s} {v:>12,d}" for k, v in sorted(groups.items())]
    lines.append(f"{'TOTAL':{width}s} {sum(groups.values()):>12,d}")
    return "\n".join(lines)
