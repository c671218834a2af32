"""The runtime sanitizer lane (port of ``repro/analysis/sanitize.py``).

``Sanitizer`` is a context manager that arms, for the duration of a run:

  * **a NaN trap**: a ``TorchDispatchMode`` that looks at the floating
    outputs of every aten op and raises ``FloatingPointError`` naming the
    op whose output holds a NaN, where the JAX package arms
    ``jax_debug_nans``. It traps NaN only, as ``jax_debug_nans`` does: the
    plain paths' ``-inf`` masks are legal. Ops that hand out uninitialized
    memory (``empty`` and its kin), a view of an input, or the inputs'
    values moved (copies, casts, concatenations, gathers, indexed writes)
    make no new value and are not looked at: a NaN they carry is named at
    the op that made it, or at the first op that computes on it. A kernel
    launched through ctypes is no aten op, so while a sanitizer is active
    the kernel wrappers hand their outputs to the same check
    (``kernels.build.check_outputs``). A CPU output is checked at once. A
    CUDA output's check is one ``amax`` (NaN propagates through it) into a
    flag buffer on the card, read back when the trap flushes, every
    ``FLUSH_EVERY`` checks, at ``mark_steady``, ``assert_steady_state`` and
    on exit: one device sync a flush where ``jax_debug_nans`` takes one an
    op. The error still names the first op whose output held a NaN, up to
    ``FLUSH_EVERY`` ops after it ran;
  * **a steady-state counter**. The port compiles nothing per call (no
    ``torch.compile``), so it counts what can recur in the port: kernel
    libraries built by nvcc or loaded by ctypes (``kernels.build.load``)
    and, on CUDA, new segments of the caching allocator (the change in
    ``torch.cuda.memory_stats()["segment.all.allocated"]``, summed over
    the cards this process has set up). After ``mark_steady()``, either
    one fails ``assert_steady_state()``: warm-up is over, and a path that
    still builds a library or grows the allocator's pool is not in its
    steady state.

The JAX package's ``tracer_leaks`` option has no torch meaning (eager
torch has no tracers to leak out of a trace), so the constructor does not
take it.

The drivers run their warm-up INSIDE the context (enter, warm up, mark
steady, measure, assert), as the JAX package's do. Nothing here runs
unless a driver is handed ``sanitize=``.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import build

_aten = torch.ops.aten
# ops whose outputs are uninitialized memory or the input re-viewed, and ops
# that only move their inputs' values: a NaN there is no arithmetic's
_UNCHECKED = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
              _aten.new_empty_strided, _aten.resize_, _aten.set_, _aten._to_copy,
              _aten.copy_, _aten.clone, _aten.cat, _aten.stack, _aten.index,
              _aten.index_select, _aten.gather, _aten.index_put_, _aten.embedding}


FLUSH_EVERY = 512  # CUDA flags a trap keeps on the card before one sync reads them
_skip: dict = {}  # op -> whether its outputs go unchecked


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def _skipped(func) -> bool:
    v = _skip.get(func)
    if v is None:
        v = _skip[func] = func.overloadpacket in _UNCHECKED or _is_view(func)
    return v


class _NaNTrap(TorchDispatchMode):
    def __init__(self, label: str):
        super().__init__()
        self.label = label
        self.pending = []  # (op, dtype, shape, device) of each flag not yet read
        # (device, dtype) -> flags written in place (each slot the amax of
        # one output) and their slots: the trap's own tensors keep one
        # size, so they take no allocator segment after warm-up
        self.flags = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _skipped(func):
            self.check(func, out)
        return out

    def check(self, what, outs) -> None:
        """Check ``outs``, the outputs of ``what`` (an aten op, or a name)."""
        for t in (outs,) if isinstance(outs, torch.Tensor) else tree_leaves(outs):
            if not (isinstance(t, torch.Tensor) and t.is_floating_point() and not t.is_meta
                    and t.layout == torch.strided and t.numel()):
                continue
            if t.device.type == "cpu":
                if torch.isnan(t).any():
                    self._raise(what, t.dtype, tuple(t.shape), t.device)
                continue
            key = (t.device, t.dtype)
            flags = self.flags.get(key)
            if flags is None:
                buf = torch.zeros(FLUSH_EVERY, dtype=t.dtype, device=t.device)
                flags = self.flags[key] = (buf, buf.unbind(0))
            torch.amax(t, dim=(), out=flags[1][len(self.pending)])
            self.pending.append((what, t.dtype, t.shape, t.device))
            if len(self.pending) == FLUSH_EVERY:
                self.flush()

    def flush(self) -> None:
        """Read the pending flags back (one sync a buffer used) and raise for
        the first op whose output held a NaN. Slot i of every buffer belongs
        to the i-th pending check, whichever buffer holds it."""
        pending, self.pending = self.pending, []
        if not pending:
            return
        n, first = len(pending), None
        for (dev, dt), (buf, _) in self.flags.items():
            hit = torch.isnan(buf[:n]).nonzero()
            for i in hit[:, 0].tolist():  # slots of this buffer that hold NaN
                if pending[i][1] == dt and pending[i][3] == dev:
                    first = i if first is None else min(first, i)
                    break
        if first is not None:
            self._raise(*pending[first])

    def _raise(self, what, dtype, shape, device):
        raise FloatingPointError(f"[{self.label}] NaN in the output of {str(what)} ({dtype} "
                                 f"{tuple(shape)} on {device})")


def _builds() -> int:
    return build.events["builds"] + build.events["loads"]


def _segments() -> int:
    """Allocator segments ever allocated on the cards this process has set
    up (0 before CUDA is initialized)."""
    if not torch.cuda.is_initialized():
        return 0
    return sum(torch.cuda.memory_stats(i).get("segment.all.allocated", 0)
               for i in range(torch.cuda.device_count()))


class SteadyStateError(AssertionError):
    """A library was built or loaded, or the allocator took a new segment,
    after ``mark_steady()``: the run is not in its steady state."""


class Sanitizer:
    """Arms the NaN trap and counts library builds and allocator segments.

    Usage (what the drivers do under ``sanitize=``)::

        san = Sanitizer(label="serve")
        with san:
            warmup_run()          # builds and new segments happen here, counted
            san.mark_steady()
            measured_run()        # must build and allocate no new segment
            san.assert_steady_state()
    """

    def __init__(self, *, nan_checks: bool = True, label: str = "run"):
        self.nan_checks = nan_checks
        self.label = label
        self._base: Optional[tuple] = None  # (builds, segments) at entry
        self._steady_at: Optional[tuple] = None  # ... at mark_steady()
        self._end: Optional[tuple] = None  # ... at exit: the counts stay readable
        self.active = False
        self._trap: Optional[_NaNTrap] = None
        self._hook = None

    # -- counts (of the last run once it has exited) -------------------------
    def _since(self, at: Optional[tuple]) -> tuple:
        if at is None:
            return 0, 0
        now = (_builds(), _segments()) if self.active else self._end
        return now[0] - at[0], now[1] - at[1]

    @property
    def builds(self) -> int:
        """Libraries built or loaded while active."""
        return self._since(self._base)[0]

    @property
    def segments(self) -> int:
        """Allocator segments taken while active."""
        return self._since(self._base)[1]

    @property
    def steady_builds(self) -> int:
        """Libraries built or loaded since ``mark_steady()`` (0 before it)."""
        return self._since(self._steady_at)[0]

    @property
    def steady_segments(self) -> int:
        """Allocator segments taken since ``mark_steady()`` (0 before it)."""
        return self._since(self._steady_at)[1]

    # -- context -----------------------------------------------------------------
    def __enter__(self) -> "Sanitizer":
        if self.active:
            raise RuntimeError(f"Sanitizer({self.label!r}) is not reentrant")
        self._base = (_builds(), _segments())
        self._steady_at = None
        self.active = True
        if self.nan_checks:
            trap = self._trap = _NaNTrap(self.label)
            trap.__enter__()
            self._hook = lambda kernel, outs: trap.check(f"the {kernel} kernel", outs)
            build.output_checks.append(self._hook)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        trap, self._trap = self._trap, None
        try:
            if trap is not None:
                trap.__exit__(exc_type, exc, tb)
                if exc_type is None:
                    trap.flush()  # a NaN found here raises from the with statement
        finally:
            if self._hook is not None:
                build.output_checks.remove(self._hook)
                self._hook = None
            self._end = (_builds(), _segments())
            self.active = False

    def _flush(self) -> None:
        if self._trap is not None:
            self._trap.flush()

    # -- steady-state contract ----------------------------------------------------
    def mark_steady(self) -> None:
        """Warm-up is over: from here on, a build or a new segment is a bug."""
        self._flush()
        self._steady_at = (_builds(), _segments())

    def assert_steady_state(self) -> None:
        self._flush()
        if self._steady_at is None:
            raise SteadyStateError(
                f"[{self.label}] assert_steady_state() without mark_steady(): nothing "
                "separates warm-up from measurement")
        b, s = self.steady_builds, self.steady_segments
        if b or s:
            raise SteadyStateError(
                f"[{self.label}] after mark_steady(): {b} kernel librar"
                f"{'y' if b == 1 else 'ies'} built or loaded, {s} new allocator "
                f"segment(s) (while active: {self.builds} and {self.segments}); some "
                "per-round or per-tick path is not in its steady state (a kernel first "
                "reached after warm-up, or tensors that outgrow the warm-up's pool)")


def coerce(sanitize: Union[bool, Sanitizer, None], *,
           label: str = "run") -> Optional[Sanitizer]:
    """Driver-keyword convenience: True -> a fresh Sanitizer, falsy -> None,
    an instance passes through (shared across drivers if desired)."""
    if isinstance(sanitize, Sanitizer):
        return sanitize
    return Sanitizer(label=label) if sanitize else None


def maybe(sanitizer: Optional[Sanitizer]):
    """``with maybe(s):``: ``s``, or a no-op when sanitizing is off."""
    return sanitizer if sanitizer is not None else contextlib.nullcontext()
