"""Spans around the port's own layer calls, timed with CUDA events.

In a traced run the harness replaces a module function of the port
(``repro_torch.models.moe.moe_block``, say) by a wrapper that records a
CUDA event before and after the call, inside a
``torch.profiler.record_function`` range of the span's name, so that a
profiler window sees the spans too.  The port looks these functions up
on their modules at each call, so the wrapper is what runs.  A function
that is not there raises: a span never reads 0 for want of its
function.

A span of kind ``autograd`` also times the function's backward: its
first tensor argument and its first output pass through an identity
autograd node that records an event when the gradient reaches it, so
the backward's span runs from the gradient reaching the output to it
leaving through the input.  A forward recomputed under activation
checkpointing counts as a forward again.
"""
from __future__ import annotations

import importlib
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import torch


class _Mark(torch.autograd.Function):
    """Identity whose backward records a CUDA event into ``rec[slot]``."""

    @staticmethod
    def forward(ctx, x, rec, slot):
        ctx.rec, ctx.slot = rec, slot
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ctx.rec[ctx.slot] = ev
        return grad, None, None


class Spans:
    """The spans of one run: name -> list of (start, end) event pairs."""

    def __init__(self):
        self.pairs: Dict[str, List[Tuple]] = defaultdict(list)
        self.backward: Dict[str, List[Dict]] = defaultdict(list)
        self._patched = []
        self.on = True

    def install(self, targets: Sequence[Tuple[str, str, str, str]]) -> None:
        """``targets``: (module, function, span name, kind) with kind
        ``call`` or ``autograd``."""
        for module, attr, name, kind in targets:
            mod = importlib.import_module(module)
            fn = getattr(mod, attr)      # AttributeError: the port changed
            setattr(mod, attr, self._wrap(fn, name, kind == "autograd"))
            self._patched.append((mod, attr, fn))

    def uninstall(self) -> None:
        for mod, attr, fn in reversed(self._patched):
            setattr(mod, attr, fn)
        self._patched = []

    def _wrap(self, fn, name: str, autograd: bool):
        def wrapper(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            rec = None
            if autograd and torch.is_grad_enabled():
                args = list(args)
                i = next((i for i, a in enumerate(args)
                          if isinstance(a, torch.Tensor) and a.requires_grad),
                         None)
                if i is not None:
                    rec = {}
                    args[i] = _Mark.apply(args[i], rec, "end")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function(name):
                start.record()
                out = fn(*args, **kwargs)
                end.record()
            self.pairs[name].append((start, end))
            if rec is not None:
                first = out[0] if isinstance(out, tuple) else out
                marked = _Mark.apply(first, rec, "start")
                out = ((marked,) + tuple(out[1:]) if isinstance(out, tuple)
                       else marked)
                self.backward[name].append(rec)
            return out
        wrapper.__wrapped__ = fn
        return wrapper

    def totals_ms(self) -> Dict[str, float]:
        """Each span's summed device time, forward and backward, in ms
        (synchronizes)."""
        torch.cuda.synchronize()
        out = {}
        for name, pairs in self.pairs.items():
            out[name] = sum(s.elapsed_time(e) for s, e in pairs)
        for name, recs in self.backward.items():
            out[name] = out.get(name, 0.0) + sum(
                r["start"].elapsed_time(r["end"]) for r in recs
                if "start" in r and "end" in r)
        return out
