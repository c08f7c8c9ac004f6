"""Compile-once serving programs (port of the JAX package's ``_counted`` and
``_TRACE_COUNTS``, ``repro.serve.engine``).

The JAX package jits each serving program and counts its traces.  The
port's counterpart of a compiled XLA program launched once a call is a
captured ``torch.cuda.CUDAGraph`` replayed once a call: a ``GraphSet``
captures a program the first time it is called at a bucket, over device
memory that stays put (the weights, and its owner's pools, slot caches or
static batch caches), and replays it after that.  An engine or a cascade
tier has one set for its batch programs (classify's last-token logits, the
batch prefill and generate's decode step, keyed by the pow2 (B, S) bucket,
plus ``max_new`` for generate) and one a slot geometry for the slot
stream's decode step and chunk buckets.  All the sets of an owner allocate
from one ``GraphPool``.  The batch set keeps at most ``BATCH_BUCKETS``
buckets: a new one evicts the least recently used, its graphs and the
static memory kept with them (generate's cache), so prompt lengths and
budgets that vary from call to call bound device memory instead of
growing it.

* The first call of a (program, bucket) stages its inputs into static
  device buffers and runs the program eagerly on a side stream: that
  warm-up loads the kernels and runs their one-time
  ``cudaFuncSetAttribute`` calls outside the capture, and its result is
  the call's result.  The program is then captured, not run, into the
  owner's memory pool.  Later calls copy their inputs into the static
  buffers and replay.
* Memory: the graphs of one pool share their intermediates' memory, which
  is safe because an owner replays one graph at a time on one stream and
  each graph's output stays allocated while the graph lives.  A later
  replay of another graph may reuse what an earlier one freed, so a
  caller reads (or copies) a graph's output before its next call, as
  every serving loop does.
* Launch accounting: a kernel wrapper counts its launch as a Python side
  effect, which fires while a graph is captured and never when it is
  replayed.  So a graph takes back the counts of its capture and adds them
  again on every replay.
* ``trace_count``/``trace_counts`` count program instances, keyed
  ``"<cfg.name>/<program>"``: a capture on the card; on the CPU, where
  there is nothing to capture, and for the programs a set runs eagerly, the
  first call of each (program, bucket) of the set.  So the CPU tests hold
  the same "flat after warm-up" counts as the card.
* A capture that fails raises: nothing falls back to eager on the card.
  ``eager=True`` runs a program eagerly on the card; it exists only as the
  oracle that graphed runs are held to.

A set holds no reference to its owner or to the functions it runs, so an
owner's graphs and buffers are freed with it by reference counting alone.
"""
from __future__ import annotations

import collections
import time
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.obs import global_registry

_TRACE_COUNTS: collections.Counter = collections.Counter()
# batch buckets an engine or tier keeps: enough for classify, generate and
# two deferred-count classes of a later tier without capturing again, while
# a zamba2-2.7b x3 tier's generate caches at (8, 144) stay under 8 GiB
BATCH_BUCKETS = 4
_CAPTURE_S = global_registry().counter("serve.graphs.capture_s")
# one warm-up and capture stream a device, shared by every set: PyTorch
# keeps a cuBLAS workspace for each stream it has run a product on, for the
# life of the process, so a stream per set would leave one behind per owner
_SIDE_STREAMS: dict = {}


def trace_count(key: Optional[str] = None) -> int:
    """Program instances (captures on the card, first calls on the CPU)
    across all serving programs, or for one ``"<cfg.name>/<program>"`` key."""
    if key is None:
        return sum(_TRACE_COUNTS.values())
    return _TRACE_COUNTS[key]


def trace_counts() -> dict:
    """Per-program instance counts, keyed ``"<cfg.name>/<program>"``."""
    return dict(_TRACE_COUNTS)


def capture_seconds() -> float:
    """Host seconds spent in first calls of graphed programs (warm-up and
    capture), process-wide."""
    return _CAPTURE_S.value


class Program:
    """A serving program: a function and the ``"<cfg.name>/<program>"`` key
    its instances are counted under.  Calling it runs the function eagerly
    and counts nothing; ``GraphSet`` counts."""

    __slots__ = ("key", "fn")

    def __init__(self, key: str, fn):
        self.key = key
        self.fn = fn

    def __call__(self, *args, **kw):
        return self.fn(*args, **kw)

    def __repr__(self):
        return f"Program({self.key})"


class GraphPool:
    """One CUDA graph memory pool (``torch.cuda.graph_pool_handle``), made
    at the first capture, shared by every ``GraphSet`` given it."""

    __slots__ = ("handle",)

    def __init__(self):
        self.handle = None

    def get(self):
        if self.handle is None:
            self.handle = torch.cuda.graph_pool_handle()
        return self.handle


class _Entry:
    __slots__ = ("static", "graph", "out", "launches")

    def __init__(self, static):
        self.static = static
        self.graph = None
        self.out = None
        self.launches = ()


class GraphSet:
    """Programs of one owner, captured over that owner's device memory, in
    the owner's ``pool`` (a pool of the set's own by default; see the
    module docstring)."""

    def __init__(self, device, pool: Optional[GraphPool] = None, max_buckets: Optional[int] = None):
        self.device = torch.device(device)
        self._entries: dict = {}
        self._pool = pool if pool is not None else GraphPool()
        self.max_buckets = max_buckets
        # bucket -> its static memory (None for a bucket that has none), in
        # order of last use
        self.buckets: collections.OrderedDict = collections.OrderedDict()

    def bucket(self, bucket, make=None):
        """Mark ``bucket`` used and return its static memory: ``make()``'s
        result, made at the bucket's first use and kept with its graphs.  A
        new bucket beyond ``max_buckets`` first evicts the least recently
        used one with its graphs and memory, so a later call there captures
        again over new memory, never replays into freed memory."""
        if bucket in self.buckets:
            self.buckets.move_to_end(bucket)
        else:
            if self.max_buckets is not None and len(self.buckets) >= self.max_buckets:
                # freed here, before ``make`` allocates its successor: the
                # set holds the only reference to a bucket's memory
                old = next(iter(self.buckets))
                del self.buckets[old]
                for k in [k for k in self._entries if k[1] == old]:
                    del self._entries[k]
            self.buckets[bucket] = None
        if self.buckets[bucket] is None and make is not None:
            self.buckets[bucket] = make()
        return self.buckets[bucket]

    def eager(self, key: str, fn, *args):
        """Run a program the set never captures, counting its first call."""
        if (key, None, False) not in self._entries:
            _TRACE_COUNTS[key] += 1
            self._entries[(key, None, False)] = None
        return fn(*args)

    def run(self, key: str, fn, *inputs, bucket=None, eager: bool = False):
        """``fn(*device_inputs)`` for ``inputs`` (host arrays or tensors) of
        shapes fixed per (key, bucket), staged into the entry's static
        buffers: captured on the card at the first call and
        replayed after; run eagerly on the CPU or with ``eager``.  Returns
        fn's result (a graph's static output: read it before the next
        call)."""
        graphed = self.device.type == "cuda" and not eager
        self.bucket(bucket)
        k = (key, bucket, graphed)
        e = self._entries.get(k)
        if e is None:
            _TRACE_COUNTS[key] += 1
            e = _Entry(tuple(torch.as_tensor(a).to(self.device, copy=True) for a in inputs))
            out = self._capture(e, fn) if graphed else fn(*e.static)
            # kept only once it ran (and was captured): a failed capture
            # leaves no entry for a later call to run eagerly
            self._entries[k] = e
            return out
        for s, a in zip(e.static, inputs):
            a = torch.as_tensor(a)
            if a.shape != s.shape:
                raise ValueError(f"{key} [{bucket}]: input {tuple(a.shape)} != static {tuple(s.shape)}")
            s.copy_(a)
        if e.graph is None:
            return fn(*e.static)
        e.graph.replay()
        for name, n in e.launches:
            build.launch_counter(name).add(n)
        return e.out

    def _capture(self, e: _Entry, fn):
        t0 = time.perf_counter()
        pool = self._pool.get()
        side = _SIDE_STREAMS.get(self.device)
        if side is None:
            side = _SIDE_STREAMS[self.device] = torch.cuda.Stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn(*e.static)  # the warm-up, and this call's result
            before = build.launch_counts()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=pool)
            try:
                e.out = fn(*e.static)
            finally:
                graph.capture_end()
            after = build.launch_counts()
        cur.wait_stream(side)
        e.launches = tuple((n, after[n] - before[n]) for n in after if after[n] != before[n])
        for name, n in e.launches:
            build.launch_counter(name).add(-n)
        e.graph = graph
        _CAPTURE_S.add(time.perf_counter() - t0)
        return out
