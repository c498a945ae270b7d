"""Spans and counters at the port's layer boundaries, off unless enabled.

    from megastep_tpu_torch import tracing
    tracing.enable()
    carry, metrics = step(carry, generator)     # any traced work
    records = tracing.drain()                   # {'spans': [...], 'counts': {...}}
    tracing.disable()

A span records its name, its parent (the index in ``records['spans']`` of the
span that encloses it, ``None`` at the top) and its start and end in
nanoseconds of ``time.perf_counter_ns()``. While a ``torch.profiler`` records,
a span also enters ``torch.profiler.record_function(name)``: it then stands in
the profiler's trace as a ``user_annotation`` of the same name, on the clock of
the trace's device operations, so that the work launched inside it, and the
device's idle gaps during it, can be put down to it. A counter adds up a named
count.

Off, which is the default, :func:`span` returns one shared object that does
nothing, after a single check, and :func:`count` is that check alone.

The spans and the counter the program records, and what reads them:

* ``train.chunk``: the whole train step; its children ``train.rollout``,
  ``train.learn`` and ``train.metrics_read``;
* ``rollout.agent``: the agent's forward and sample in each rollout step;
* ``env.step``: the body of ``Explorer.step`` and ``Deathmatch.step``;
  ``env.rebake``: Deathmatch's model draw and re-bake;
* ``learn.forward``, ``learn.backward``, ``learn.optimizer``, ``learn.kl_read``:
  each minibatch's loss, its backward, the optimizer step and the KL stop's
  host read. On a card with no mesh the loss and backward are a CUDA graph's
  replay, and ``learn.graph`` takes the place of the first two: the
  minibatch's gather into the graph's inputs and the replay (and, once, the
  eager warm-up, as ``learn.forward`` and ``learn.backward``, and the
  capture);
* ``core.mamba``, ``core.attention``: each Mamba-2 mixer call and each
  attention mixer call of the hybrid core (``models/hybrid.py``), in the
  rollout's steps and, on the eager path, in the learner's forward (a CUDA
  graph's replay runs none: its spans ran once, at capture);
* ``scene.scenery``, ``spawns.tables``, ``kernels.build``: set-up (the scene
  pass and bake, the spawn tables, a kernel's ``nvcc`` build);
* the counter ``host_syncs``: one for each device-to-host read on the train
  step's path;
* the counters ``learn_graph_captures`` and ``learn_graph_replays``: one for
  each capture of the learner's graph and one for each replay, which is one
  for each minibatch on the graph path;
* the counter ``ssm_state_bytes``: the bytes of SSM and conv state that the
  hybrid core's one-step (T=1) mixer calls read and write, from their shapes.
* the counter ``rebake_launches``: one for each launch of the re-bake kernel
  (``ops/fused.py::rebake``), which is one a Deathmatch step on a card, inside
  ``env.rebake``.
"""
import threading
import time

import torch


class _Off:
    """The span that records nothing: what :func:`span` returns when off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Tracer:
    """What a recording holds: spans as ``[name, parent, start_ns, end_ns]``,
    the counts, and each thread's stack of open spans."""

    def __init__(self):
        self.spans, self.counts = [], {}
        self.local = threading.local()

    def stack(self):
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack


class _Span:
    __slots__ = ('tracer', 'name', 'index', 'annotation')

    def __init__(self, tracer, name):
        self.tracer, self.name, self.annotation = tracer, name, None

    def __enter__(self):
        tracer = self.tracer
        stack = tracer.stack()
        if torch._C._autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.index = len(tracer.spans)
        tracer.spans.append([self.name, stack[-1] if stack else None,
                             time.perf_counter_ns(), None])
        stack.append(self.index)
        return self

    def __exit__(self, *exc):
        self.tracer.spans[self.index][3] = time.perf_counter_ns()
        self.tracer.stack().pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


_on = False
_tracer = _Tracer()


def enable():
    """Turns recording on. From off, it starts a new recording: what an earlier
    one left undrained is dropped."""
    global _on, _tracer
    if not _on:
        _tracer = _Tracer()
        _on = True


def disable():
    """Turns recording off; what was recorded waits for :func:`drain`."""
    global _on
    _on = False


def enabled():
    """Whether spans and counts are being recorded."""
    return _on


def span(name):
    """A context manager that records the span ``name`` while on, and the
    shared :data:`OFF` while off."""
    if not _on:
        return OFF
    return _Span(_tracer, name)


def count(name, n=1):
    """Adds ``n`` to the counter ``name`` while on."""
    if _on:
        _tracer.counts[name] = _tracer.counts.get(name, 0) + n


def drain():
    """The records so far, which it clears: ``spans``, a list of dicts with
    ``name``, ``parent`` (an index into the list, or None), ``start_ns`` and
    ``end_ns``, in the order the spans were entered; and ``counts``. Raises
    inside an open span of this thread, whose children would lose their
    parent."""
    global _tracer
    if _tracer.stack():
        raise RuntimeError(f'drain() inside the open span {_tracer.spans[_tracer.stack()[-1]][0]!r}')
    spans = [dict(name=n, parent=p, start_ns=s, end_ns=e) for n, p, s, e in _tracer.spans]
    counts = dict(_tracer.counts)
    _tracer = _Tracer()
    return dict(spans=spans, counts=counts)
