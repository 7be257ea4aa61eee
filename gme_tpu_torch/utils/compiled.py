"""`compiled`: the port's `jax.jit`, as captured CUDA graphs.

The JAX package compiles its entry points with `jax.jit`: one XLA program
per set of shapes and static arguments, dispatched once, reading nothing
back to the host.  Here a compiled function is one captured CUDA graph per
key:

    key = (static arguments, each tensor argument's shape, dtype, device,
           every other non-tensor argument)

- On the CPU, or with no tensor argument on a CUDA device, the call runs
  the function itself: the CPU has no graphs, and the result is the same
  function's.
- Under `guards.debug_checks()` the call runs the function itself too, so
  that its checks are read: the JAX package reads its checks when it
  traces, and its compiled programs run without them.  A capture never
  reads a guard.
- On CUDA, the first call of a key runs the function once eagerly on a
  side stream (it loads the kernel library and runs each wrapper's
  first-shape work), captures it into a CUDA graph in the function's memory
  pool, and replays the graph.  Later calls copy their tensors into the
  entry's input buffers, replay, and return copies of the outputs, so a
  later call never overwrites an earlier result (JAX arrays are immutable).
- A capture that fails raises, naming the function and the line where it
  broke; nothing falls back to the eager function.
- A function called inside another compiled function's capture runs
  inline, as a jitted function inside `jit` does.

Each compiled function keeps at most MAX_ENTRIES keys (the least recently
used goes first) and one memory pool per device, shared by its entries:
their replays run one after another on the caller's stream, and every
output is copied before the next replay, so no entry reads memory that
another's replay wrote.  `clear()` frees every graph and the pools.

A compiled function made with `split=True` may also take, and write,
tensors on several devices: its body moves data between devices only
through `transfer` (in the port, the band program's collectives,
`parallel/spatial.py`).  A cross-device copy orders the two devices'
streams against each other, which no capture on one device can hold, so
its capture splits there: between two transfers each device the body runs
on has one graph (a segment), captured on that device's side stream in its
pool, and each transfer is a step of copies run by the host between the
segments, from tensors the segments wrote into buffers the entry keeps.
Adjacent transfers with no device work between them form one step.  A
replay makes the other devices' current streams wait on the caller's,
replays each segment on its device's current stream (the devices run their
segments at the same time), runs each step's copies grouped by (source,
target) device, all of a step's groups in one call into the kernel library
(`csrc/peer_copy.cu`), and makes the caller's stream wait on every other
device.  A group within one device is plain copies on its stream.  A group
between two cards is one event pair: an event recorded on the source
card's stream that the target card's stream waits on, the group's raw
peer copies (`cudaMemcpyPeerAsync`) on the target's stream, and an event
recorded after them that the source's stream waits on, since its next
segment overwrites the copies' sources.  Peer access is enabled where
`torch.cuda.can_device_access_peer` says it exists (`PEER_ACCESS`).  A
failed copy raises.  Such a function captures this way on one device too.
On the CPU its body runs with the transfers copying, and `last_entry`
holds the plan of segments and steps, without graphs.

`while_loop(cond, body, state, chunk)` is the counterpart of
`lax.while_loop` for loops whose body is masked (a finished element does
not change): while `cond(state)` is true, `chunk` steps.  Eagerly the host
reads the condition before each chunk.  Inside a capture the loop is a
conditional WHILE node of the graph (CUDA 12.4 and later;
`csrc/graph_conditional.cu`), and the card decides: a one-thread kernel
sets the node's condition from the first `cond(state)` before the node, and
the node's body, captured on a second side stream into a memory pool of the
entry's own, is `_loop_chunk` (the `chunk` steps written back into the
state's buffers, a count of body runs, the next condition) and the kernel
again.  A replay reads nothing back, however many times the body runs.  A
split capture runs the loop eagerly, so its read of the condition fails
the capture.

Launches.  The kernel wrappers count their launches (`cuda_kernels.LAUNCHES`)
where they launch, which a replay does not do.  A capture records the
graph's launches, and each loop body's apart, and leaves `LAUNCHES` as it
found it.  A replay adds its graph's own launches to the replay counts; a
loop body's launches times its runs are added when the counts are read
(`replay_launches()`, which reads each body's counter on the device: call
it after a synchronise, never on a call's path).  So `LAUNCHES` counts the
eager launches, `replay_launches()` the launches the replays made, and
`Entry.launches` one call's (the last call's).  `capture_stats()` counts
the captures made since the process started and the seconds they took,
each capture's warm-up run included.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import ctypes
import inspect
import os
import threading
import time
import traceback
import warnings
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from gme_tpu_torch.ops import cuda_kernels
from gme_tpu_torch.utils import guards

# Keys a compiled function keeps, the least recently used freed first.
MAX_ENTRIES = 8

# Set while a compiled function's body runs for its warm-up or capture: a
# compiled function called then runs inline, `while_loop` makes a WHILE
# node, and `transfer` splits a split capture.
_TRACING: contextvars.ContextVar = contextvars.ContextVar("gme_tpu_torch_compiled", default=None)

# Launches of the replays since `reset_replay_counts`, the loop bodies' as
# far as they were folded in; the loop bodies of the live entries.
_REPLAY_LAUNCHES: Dict[str, int] = {name: 0 for name in cuda_kernels.LAUNCHES}
_LOOPS: "weakref.WeakSet[_Loop]" = weakref.WeakSet()

# Captures (`Compiled._capture`, `_capture_split`) since the process started.
_CAPTURES: Dict[str, float] = {"count": 0, "seconds": 0.0}
_CAPTURES_LOCK = threading.Lock()


def _fold(loops) -> None:
    """Add each loop body's launches times its runs since the last fold."""
    for loop in loops:
        total = int(loop.runs[1])
        for name, n in loop.launches.items():
            _REPLAY_LAUNCHES[name] += (total - loop.folded) * n
        loop.folded = total


def replay_launches() -> Dict[str, int]:
    """Launches of each kernel made by replays since the counts were last
    set to 0: the graphs' own and the loop bodies', whose runs it reads
    from their counters on the device (module docstring)."""
    _fold(list(_LOOPS))
    return dict(_REPLAY_LAUNCHES)


def capture_stats() -> Dict[str, float]:
    """{"count": captures, "seconds": their wall time} since the process
    started, failed captures included."""
    with _CAPTURES_LOCK:
        return dict(_CAPTURES)


def reset_replay_counts() -> None:
    _fold(list(_LOOPS))
    for name in _REPLAY_LAUNCHES:
        _REPLAY_LAUNCHES[name] = 0


class CaptureError(RuntimeError):
    """A compiled function could not be captured into a CUDA graph."""


# ---------------------------------------------------------------------------
# Argument trees
# ---------------------------------------------------------------------------

def _flatten(tree) -> Tuple[List[torch.Tensor], Any]:
    """(tensor leaves, structure): dicts, lists and tuples are walked; a
    non-tensor leaf stays in the structure (and so in the key)."""
    leaves: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return ("T",)
        if isinstance(x, dict):
            return ("D", tuple((k, walk(v)) for k, v in x.items()))
        if isinstance(x, (list, tuple)):
            return ("L" if isinstance(x, list) else "U", tuple(walk(v) for v in x))
        return ("V", x)

    return leaves, walk(tree)


def _unflatten(struct, leaves):
    it = iter(leaves)

    def build(s):
        tag = s[0]
        if tag == "T":
            return next(it)
        if tag == "D":
            return {k: build(v) for k, v in s[1]}
        if tag in ("L", "U"):
            items = [build(v) for v in s[1]]
            return items if tag == "L" else tuple(items)
        return s[1]

    return build(struct)


def _key(static, struct, leaves):
    return (static, struct, tuple((tuple(t.shape), t.dtype, t.device) for t in leaves))


def _failing_line(tb) -> str:
    """The innermost line of a traceback outside this module and torch:
    the op of the compiled function that broke its capture."""
    torch_dir = os.path.dirname(os.path.abspath(torch.__file__))
    frames = [f for f in traceback.extract_tb(tb)
              if f.filename != os.path.abspath(__file__) and not f.filename.startswith(torch_dir)]
    if not frames:
        return "an unknown line"
    f = frames[-1]
    return f"{f.filename}:{f.lineno} `{f.line}`"


# ---------------------------------------------------------------------------
# Capture sessions and entries
# ---------------------------------------------------------------------------

@dataclass(eq=False)
class _Loop:
    """A WHILE node of a graph: one run of its body launches `launches`;
    `runs` (int64, on the device) counts its body's runs, [0] in the last
    replay and [1] since the capture, of which `folded` are counted in
    `_REPLAY_LAUNCHES`."""
    runs: torch.Tensor
    launches: Dict[str, int]
    folded: int = 0


@dataclass
class _Graph:
    graph: Any  # torch.cuda.CUDAGraph; None in a plan counted on the CPU
    launches: Dict[str, int]  # a replay's, outside the loop bodies
    loops: List[_Loop] = field(default_factory=list)
    # The (device, pool) of the loop bodies and the captures that hold it:
    # the bodies' temporaries stay in it until the graph is released.
    body_pool: Any = None
    body_pool_uses: int = 0

    def reset(self) -> None:
        _fold(self.loops)
        for loop in self.loops:
            _LOOPS.discard(loop)
        self.graph.reset()
        _release_pool(self.body_pool, self.body_pool_uses)
        self.body_pool_uses = 0


# (card, peer) -> whether the card's access to the peer's memory was enabled,
# for the cards a collective step has copied between (`_enable_peer`).
PEER_ACCESS: Dict[Tuple[int, int], bool] = {}


def _enable_peer(a: int, b: int) -> None:
    """Enable access both ways between cards a and b where
    `torch.cuda.can_device_access_peer` says it exists; record in
    `PEER_ACCESS` whether it was."""
    for dev, peer in ((a, b), (b, a)):
        if (dev, peer) in PEER_ACCESS:
            continue
        ok = torch.cuda.can_device_access_peer(dev, peer)
        if ok:
            _cuda_call(f"enable cuda:{dev}'s access to cuda:{peer}",
                       cuda_kernels.load_library().gme_enable_peer(dev, peer))
        PEER_ACCESS[dev, peer] = ok


class _StepTable:
    """A step's groups as `csrc/peer_copy.cu`'s `gme_run_step` takes them:
    per group its source and target card, its count of copies and its event
    pair (recorded once here so that each event exists on its card), then
    every copy's target, source and bytes, group by group."""

    def __init__(self, groups):
        n = len(groups)
        ints = ctypes.c_int * n
        self.n = n
        self.src = ints(*[s.index for s, _ in groups])
        self.dst = ints(*[d.index for _, d in groups])
        self.count = ints(*[len(c) for c in groups.values()])
        self.events = []  # the events' owners
        sent, done = [], []
        for s, d in groups:
            if s == d:
                sent.append(None)
                done.append(None)
                continue
            _enable_peer(s.index, d.index)
            pair = torch.cuda.Event(), torch.cuda.Event()
            pair[0].record(torch.cuda.current_stream(s))
            pair[1].record(torch.cuda.current_stream(d))
            self.events.append(pair)
            sent.append(pair[0].cuda_event)
            done.append(pair[1].cuda_event)
        self.sent = (ctypes.c_void_p * n)(*sent)
        self.done = (ctypes.c_void_p * n)(*done)
        copies = [c for cs in groups.values() for c in cs]
        self.dsts = (ctypes.c_void_p * len(copies))(*[d.data_ptr() for d, _ in copies])
        self.srcs = (ctypes.c_void_p * len(copies))(*[s.data_ptr() for _, s in copies])
        self.bytes = (ctypes.c_size_t * len(copies))(
            *[s.numel() * s.element_size() for _, s in copies])


@dataclass
class _Step:
    """A split entry's collective step: copies (dst, src) run by the host
    between two segments, from tensors the segments before wrote into
    buffers the entry keeps (so eager work never reuses them), in groups by
    (source, target) device (module docstring)."""
    copies: List[Tuple[torch.Tensor, torch.Tensor]]
    _table: Optional[_StepTable] = field(default=None, repr=False)

    @property
    def groups(self) -> Dict[Tuple[torch.device, torch.device],
                             List[Tuple[torch.Tensor, torch.Tensor]]]:
        """The copies by (source device, target device), each in order."""
        out: Dict[Tuple[torch.device, torch.device], List] = {}
        for dst, src in self.copies:
            out.setdefault((src.device, dst.device), []).append((dst, src))
        return out

    @property
    def pairs(self) -> int:
        """The event pairs a run records: one per group between two devices."""
        return sum(src != dst for src, dst in self.groups)

    def run(self, streams) -> None:
        """Enqueue the copies; `streams[k]` is card k's current stream."""
        if self._table is None:
            self._table = _StepTable(self.groups)
        t = self._table
        _cuda_call(f"run a collective step of {len(self.copies)} copies",
                   cuda_kernels.load_library().gme_run_step(
                       t.n, t.src, t.dst, t.count, t.sent, t.done, t.dsts, t.srcs, t.bytes,
                       streams))


@dataclass
class Entry:
    """One key's captured plan: its graph or, in a split entry, graphs and
    collective steps in order.  `devices` are the devices a split entry's
    segments run on, the caller's first."""
    inputs: List[torch.Tensor]
    outputs: List[torch.Tensor]
    out_struct: Any
    plan: List[Union[_Graph, _Step]] = field(default_factory=list)
    devices: Tuple[torch.device, ...] = ()
    # A split capture's segments that captured nothing: never replayed, kept
    # until release, since resetting a graph gives up its hold on the pool
    # that the next capture on that device shares.
    empty: List[Any] = field(default_factory=list)

    @property
    def graphs(self) -> List[_Graph]:
        return [g for g in self.plan if isinstance(g, _Graph)]

    @property
    def steps(self) -> List[_Step]:
        return [s for s in self.plan if isinstance(s, _Step)]

    @property
    def loops(self) -> List[_Loop]:
        return [loop for g in self.graphs for loop in g.loops]

    @property
    def launches(self) -> Dict[str, int]:
        """The last call's launches of each kernel: read from the loop
        bodies' counters on the device."""
        out = collections.Counter()
        for g in self.graphs:
            out.update(g.launches)
            for loop in g.loops:
                runs = int(loop.runs[0])
                out.update({k: runs * n for k, n in loop.launches.items()})
        return {k: out.get(k, 0) for k in _REPLAY_LAUNCHES}

    def replay(self) -> None:
        """Replay on the caller's current streams; the caller's device is
        the current device."""
        caller = torch.cuda.current_stream()
        others = [torch.cuda.current_stream(d) for d in self.devices[1:]]
        for s in others:
            s.wait_stream(caller)
        streams = None  # each device's current stream, by index, for the steps
        for g in self.plan:
            if isinstance(g, _Step):
                if streams is None:
                    streams = (ctypes.c_void_p * (max(d.index for d in self.devices) + 1))()
                    for d, s in zip(self.devices, [caller] + others):
                        streams[d.index] = s.cuda_stream
                g.run(streams)
                continue
            g.graph.replay()
            for name, n in g.launches.items():
                _REPLAY_LAUNCHES[name] += n
        for s in others:
            caller.wait_stream(s)

    def release(self) -> None:
        if self.steps:  # the steps' buffers may still be in use on any device
            for d in self.devices:
                torch.cuda.synchronize(d)
        for g in self.graphs:
            g.reset()
        for g in self.empty:
            g.reset()
        self.empty.clear()
        self.plan.clear()
        self.inputs.clear()
        self.outputs.clear()


class _Session:
    """One capture: one graph in one pool on one stream, with a WHILE node
    for each `while_loop` (module docstring)."""

    def __init__(self, pool):
        self.pool = pool
        self.graph: Optional[_Graph] = None
        self._before = None  # the launch counts when the open capture began

    def begin(self) -> None:
        g = torch.cuda.CUDAGraph()
        before = dict(cuda_kernels.LAUNCHES)
        g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self.graph = _Graph(g, {})
        self._before = before

    def end(self) -> None:
        before, self._before = self._before, None
        self.graph.graph.capture_end()
        self.graph.launches = _launched_since(before)
        # The capture recorded these launches without running them.
        cuda_kernels.LAUNCHES.update(before)

    def abort(self) -> None:
        if self.graph is None:
            return
        if self._before is not None:
            cuda_kernels.LAUNCHES.update(self._before)
            self._before = None
            with contextlib.suppress(RuntimeError):
                self.graph.graph.capture_end()
        self.graph.loops.clear()  # never replayed: nothing to count
        self.graph.reset()
        self.graph = None

    def loop(self, cond: Callable, body: Callable, state: Tuple[torch.Tensor, ...],
             chunk: int) -> None:
        """`while_loop` as a WHILE node of the open graph, on the buffers
        of `state` (module docstring)."""
        lib = cuda_kernels.load_library()
        device = state[0].device
        outer = torch.cuda.current_stream(device)
        inner = _side_stream(device, body=True)
        g = self.graph
        if g.body_pool is None:
            g.body_pool = (device.index, torch.cuda.graph_pool_handle())
        runs = torch.empty(2, dtype=torch.int64, device=device)  # set to 0 after the capture
        runs[0].zero_()
        handle = ctypes.c_ulonglong()
        _graph_call("make the condition handle",
                    lib.gme_while_handle(ctypes.c_void_p(outer.cuda_stream), ctypes.byref(handle)))
        _graph_call("set the first condition", lib.gme_while_set(
            handle, ctypes.c_void_p(cond(state).data_ptr()), ctypes.c_void_p(outer.cuda_stream)))
        before = dict(cuda_kernels.LAUNCHES)
        _graph_call("add the WHILE node", lib.gme_while_begin(
            ctypes.c_void_p(outer.cuda_stream), ctypes.c_void_p(inner.cuda_stream), handle))
        try:
            with torch.cuda.stream(inner):
                torch._C._cuda_beginAllocateCurrentStreamToPool(*g.body_pool)
                g.body_pool_uses += 1
                try:
                    flag = _loop_chunk(cond, body, state, chunk, runs)
                    _graph_call("set the next condition", lib.gme_while_set(
                        handle, ctypes.c_void_p(flag.data_ptr()),
                        ctypes.c_void_p(inner.cuda_stream)))
                finally:
                    torch._C._cuda_endAllocateToPool(*g.body_pool)
        except BaseException:
            lib.gme_while_end(ctypes.c_void_p(inner.cuda_stream))  # the caller aborts
            raise
        _graph_call("end the body's capture",
                    lib.gme_while_end(ctypes.c_void_p(inner.cuda_stream)))
        g.loops.append(_Loop(runs, _launched_since(before)))
        # The capture recorded the body's launches without running them.
        cuda_kernels.LAUNCHES.update(before)


def _launched_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in cuda_kernels.LAUNCHES.items() if v != before[k]}


def _cuda_call(step: str, err: int) -> None:
    if err != 0:
        msg = cuda_kernels.load_library().gme_error_string(err).decode()
        raise RuntimeError(f"could not {step}: {msg} ({err})")


def _graph_call(step: str, err: int) -> None:
    _cuda_call(f"{step} of a while_loop", err)


def _release_pool(pool, uses: int) -> None:
    for _ in range(uses):
        torch._C._cuda_releasePool(*pool)


_STREAMS: Dict[Tuple[torch.device, bool], Any] = {}


def _side_stream(device: torch.device, body: bool = False):
    """The device's stream for captures, or for loop bodies."""
    if (device, body) not in _STREAMS:
        _STREAMS[device, body] = torch.cuda.Stream(device)
    return _STREAMS[device, body]


def _is_view(func) -> bool:
    returns = func._schema.returns
    return bool(returns) and all(r.alias_info is not None and not r.alias_info.is_write
                                 for r in returns)


class _WorkWatch(TorchDispatchMode):
    """Records the devices of every tensor an op other than a view reads or
    writes: the devices that have work in the open segments."""

    def __init__(self):
        super().__init__()
        self.devices = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _is_view(func):
            self.devices.update(t.device for t in tree_leaves((args, kwargs, out))
                                if isinstance(t, torch.Tensor))
        return out


class _Split:
    """A split capture (module docstring): the plan of segments and steps.
    `pools` maps each device the body runs on to its memory pool; with no
    pools (the CPU) nothing is captured, the body runs and each transfer
    copies at once, so the plan is counted."""

    def __init__(self, pools: Optional[Dict[torch.device, Any]] = None):
        self.pools = pools
        self.plan: List[Union[_Graph, _Step]] = []
        self.empty: List[Any] = []  # graphs that captured nothing (`Entry.empty`)
        self.watch = _WorkWatch()
        self._open: Dict[torch.device, Any] = {}
        self._before: Dict[str, int] = {}

    def begin(self) -> None:
        self._before = dict(cuda_kernels.LAUNCHES)
        for d, pool in (self.pools or {}).items():
            g = torch.cuda.CUDAGraph()
            with torch.cuda.device(d):
                # relaxed: ending one device's segment instantiates its graph
                # while the other devices' captures are still open, which
                # thread_local refuses (cudaErrorStreamCaptureUnsupported).
                # A host read still fails (it synchronises a capturing
                # stream), and the driver's other threads are free as under
                # thread_local.
                g.capture_begin(pool=pool, capture_error_mode="relaxed")
            self._open[d] = g
        # After the captures begin: `capture_begin` fills the random
        # generator's seed and offset, which is no work of the body.
        self.watch.devices.clear()

    def end(self) -> None:
        """End the open segments; keep one graph per device that had work."""
        launches = {k: v - self._before[k] for k, v in cuda_kernels.LAUNCHES.items()
                    if v != self._before[k]}
        # The capture recorded these launches without running them.
        cuda_kernels.LAUNCHES.update(self._before)
        worked = self.watch.devices
        outside = {d for d in worked if d.type == "cuda"} - set(self.pools or worked)
        if outside:  # the caller aborts
            raise RuntimeError(f"work on devices outside the capture: {sorted(map(str, outside))}")
        kept = []
        for d in list(self._open):
            g = self._open.pop(d)
            with torch.cuda.device(d):
                if d in worked:
                    g.capture_end()
                    kept.append(_Graph(g, {}))
                else:
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")  # "the CUDA Graph is empty"
                        g.capture_end()
                    self.empty.append(g)
        if self.pools is None:
            kept = [_Graph(None, {}) for _ in sorted(map(str, worked))]
        if kept:
            kept[0].launches = launches
        self.plan.extend(kept)

    def transfer(self, moves: Sequence[Tuple[torch.Tensor, torch.device]]) -> List[torch.Tensor]:
        srcs = [t.contiguous() for t, _ in moves]
        self.end()
        dsts = [torch.empty(s.shape, dtype=s.dtype, device=d) for s, (_, d) in zip(srcs, moves)]
        if self.pools is None:
            for dst, src in zip(dsts, srcs):
                dst.copy_(src)
        if self.plan and isinstance(self.plan[-1], _Step):
            self.plan[-1].copies.extend(zip(dsts, srcs))  # no device work since the last step
        else:
            self.plan.append(_Step(list(zip(dsts, srcs))))
        self.begin()
        return dsts

    def abort(self) -> None:
        cuda_kernels.LAUNCHES.update(self._before)
        open_, self._open = self._open, {}
        for d, g in open_.items():
            with torch.cuda.device(d), contextlib.suppress(RuntimeError):
                g.capture_end()
            g.reset()
        for g in self.plan:
            if isinstance(g, _Graph) and g.graph is not None:
                g.graph.reset()
        for g in self.empty:
            g.reset()


def transfer(moves: Sequence[Tuple[torch.Tensor, torch.device]]) -> List[torch.Tensor]:
    """Each (tensor, device) of `moves` on its device: the one way the body
    of a compiled function made with `split=True` moves data between
    devices.  Eagerly `tensor.to(device)`; inside a split capture a
    collective step (module docstring), whose results are buffers of the
    entry, copies even on one device."""
    split = _TRACING.get()
    if isinstance(split, _Split):
        return split.transfer(moves)
    return [t.to(d) for t, d in moves]


def _loop_chunk(cond: Callable, body: Callable, state: Tuple[torch.Tensor, ...], chunk: int,
                runs: torch.Tensor) -> torch.Tensor:
    """One run of `while_loop`'s body: `chunk` steps written back into the
    buffers of `state` (a WHILE node's body replays on fixed addresses), 1
    added to each count of `runs`; returns the next condition.  The eager
    loop runs it while the host reads the condition true; a capture makes
    it a WHILE node's body, which the card runs while it is true."""
    new = state
    for _ in range(chunk):
        new = tuple(body(new))
    for dst, src in zip(state, new):
        dst.copy_(src)
    runs.add_(1)
    return cond(state)


def while_loop(cond: Callable, body: Callable, state: Tuple[torch.Tensor, ...], chunk: int):
    """Run `body` on the tuple of tensors `state` in chunks of `chunk`
    steps while `cond(state)`, a 0-dim bool tensor, is true before a chunk;
    returns the final state.  `body` must leave a finished state as it is
    (masked steps), so steps past the end change nothing.  Eagerly one host
    read of `cond` per chunk and one that ends the loop; inside a capture a
    WHILE node, which the host never reads (module docstring)."""
    state = tuple(t.clone() for t in state)
    sess = _TRACING.get()
    if isinstance(sess, _Session):
        sess.loop(cond, body, state, chunk)
        return state
    runs = torch.zeros(2, dtype=torch.int64, device=state[0].device)
    flag = cond(state)
    while bool(flag):
        flag = _loop_chunk(cond, body, state, chunk, runs)
    return state


class Compiled:
    """A function compiled into CUDA graphs per key (module docstring)."""

    def __init__(self, fn: Callable, static_argnames: Tuple[str, ...] = (), split: bool = False):
        self.fn = fn
        self.split = split
        self.name = getattr(fn, "__qualname__", repr(fn))
        self.static_argnames = tuple(static_argnames)
        self.signature = inspect.signature(fn)
        unknown = set(self.static_argnames) - set(self.signature.parameters)
        if unknown:
            raise ValueError(f"{self.name}: no arguments named {sorted(unknown)}")
        self.entries: "collections.OrderedDict[Any, Entry]" = collections.OrderedDict()
        self.last_entry: Optional[Entry] = None  # the entry the last call on CUDA replayed
        self._pools: Dict[torch.device, Any] = {}
        self._lock = threading.Lock()
        self.__wrapped__ = fn
        self.__doc__ = fn.__doc__

    def __repr__(self) -> str:
        return f"<compiled {self.name}, {len(self.entries)} entries>"

    def _split(self, args, kwargs):
        bound = self.signature.bind(*args, **kwargs)
        bound.apply_defaults()
        static = tuple((k, bound.arguments[k]) for k in self.static_argnames)
        dynamic = {k: v for k, v in bound.arguments.items() if k not in self.static_argnames}
        leaves, struct = _flatten(dynamic)
        return static, dynamic, leaves, struct

    def key(self, *args, **kwargs):
        """The cache key of a call: the static arguments, the structure of
        the others with their non-tensor values, and each tensor's shape,
        dtype and device."""
        static, _, leaves, struct = self._split(args, kwargs)
        return _key(static, struct, leaves)

    def __call__(self, *args, **kwargs):
        static, dynamic, leaves, struct = self._split(args, kwargs)
        devices = {t.device for t in leaves}
        if _TRACING.get() is not None or guards.checks_enabled():
            return self.fn(*args, **kwargs)
        if not any(d.type == "cuda" for d in devices):
            return self._count_split(args, kwargs) if self.split else self.fn(*args, **kwargs)
        if len(devices) != 1 and not self.split:
            raise ValueError(f"{self.name}: tensors on different devices: "
                             f"{sorted(map(str, devices))}")
        device = next(t.device for t in leaves if t.device.type == "cuda")
        key = _key(static, struct, leaves)
        with self._lock:
            entry = self.entries.get(key)
            if entry is None:
                capture = self._capture_split if self.split else self._capture
                t0 = time.perf_counter()
                try:
                    entry = capture(static, struct, leaves, device)
                finally:
                    with _CAPTURES_LOCK:
                        _CAPTURES["count"] += 1
                        _CAPTURES["seconds"] += time.perf_counter() - t0
                self.entries[key] = entry
                while len(self.entries) > MAX_ENTRIES:
                    self.entries.popitem(last=False)[1].release()
            else:
                self.entries.move_to_end(key)
                for buf, t in zip(entry.inputs, leaves):
                    buf.copy_(t)
            with torch.cuda.device(device):
                entry.replay()
                outs = [t.clone() for t in entry.outputs]
            self.last_entry = entry
        return _unflatten(entry.out_struct, outs)

    def prepare(self, *args, **kwargs) -> Entry:
        """The entry of this call's key, captured by an earlier call, with
        this call's tensors copied into its input buffers: `replay()` then
        runs its graphs alone, without a call's copies in and clones out
        (a profiler's view of the compiled function)."""
        static, _, leaves, struct = self._split(args, kwargs)
        with self._lock:
            entry = self.entries[_key(static, struct, leaves)]
            for buf, t in zip(entry.inputs, leaves):
                buf.copy_(t)
        return entry

    def _call_body(self, static, struct, inputs):
        kwargs = dict(_unflatten(struct, inputs))
        kwargs.update(static)
        return self.fn(**kwargs)

    def _capture(self, static, struct, leaves, device) -> Entry:
        inputs = [torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t) for t in leaves]
        stream = _side_stream(device)
        with torch.cuda.device(device):
            # Warm-up: one eager run on the side stream.
            stream.wait_stream(torch.cuda.current_stream(device))
            token = _TRACING.set("warm-up")
            try:
                with torch.cuda.stream(stream):
                    self._call_body(static, struct, inputs)
            finally:
                _TRACING.reset(token)
            torch.cuda.current_stream(device).wait_stream(stream)
            torch.cuda.synchronize(device)
            if device not in self._pools:
                self._pools[device] = torch.cuda.graph_pool_handle()
            sess = _Session(self._pools[device])
            token = _TRACING.set(sess)
            try:
                with torch.cuda.stream(stream):
                    sess.begin()
                    out = self._call_body(static, struct, inputs)
                    sess.end()
                    for loop in sess.graph.loops:
                        loop.runs.zero_()
                        _LOOPS.add(loop)
            except Exception as e:
                with torch.cuda.stream(stream):
                    sess.abort()
                raise CaptureError(
                    f"compiled {self.name}: the CUDA graph capture failed at "
                    f"{_failing_line(e.__traceback__)}: {type(e).__name__}: {e}") from e
            finally:
                _TRACING.reset(token)
            torch.cuda.current_stream(device).wait_stream(stream)
        outputs, out_struct = _flatten(out)
        return Entry(inputs, outputs, out_struct, [sess.graph], (device,))

    def _count_split(self, args, kwargs):
        """The body on the CPU under a split session that captures nothing:
        the transfers copy, and `last_entry` holds the plan."""
        split = _Split()
        token = _TRACING.set(split)
        try:
            with split.watch:
                split.begin()
                out = self.fn(*args, **kwargs)
                split.end()
        finally:
            _TRACING.reset(token)
        self.last_entry = Entry([], [], None, split.plan)
        return out

    def _capture_split(self, static, struct, leaves, device) -> Entry:
        inputs = [torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t) for t in leaves]
        # Warm-up: one eager run on the current streams, watched for the
        # devices the body runs on.
        watch = _WorkWatch()
        token = _TRACING.set("warm-up")
        try:
            with torch.cuda.device(device), watch:
                self._call_body(static, struct, inputs)
        finally:
            _TRACING.reset(token)
        devices = [device] + sorted({d for d in watch.devices if d.type == "cuda"} - {device},
                                    key=str)
        for d in devices:
            torch.cuda.synchronize(d)
            if d not in self._pools:
                self._pools[d] = torch.cuda.graph_pool_handle()
        split = _Split({d: self._pools[d] for d in devices})
        with contextlib.ExitStack() as stack:
            for d in devices:
                side = _side_stream(d)
                side.wait_stream(torch.cuda.current_stream(d))
                stack.enter_context(torch.cuda.stream(side))
            stack.enter_context(torch.cuda.device(device))
            token = _TRACING.set(split)
            try:
                with split.watch:
                    split.begin()
                    out = self._call_body(static, struct, inputs)
                    split.end()
            except Exception as e:
                split.abort()
                raise CaptureError(
                    f"compiled {self.name}: the CUDA graph capture failed at "
                    f"{_failing_line(e.__traceback__)}: {type(e).__name__}: {e}") from e
            finally:
                _TRACING.reset(token)
        for d in devices:
            torch.cuda.current_stream(d).wait_stream(_side_stream(d))
        outputs, out_struct = _flatten(out)
        return Entry(inputs, outputs, out_struct, split.plan, tuple(devices), split.empty)

    def clear(self) -> None:
        """Free every entry's graphs and buffers, and the memory pools."""
        with self._lock:
            for entry in self.entries.values():
                entry.release()
            self.entries.clear()
            self._pools.clear()
            self.last_entry = None


def compiled(fn: Callable, static_argnames: Tuple[str, ...] = (), split: bool = False) -> Compiled:
    """`fn` compiled per key into CUDA graphs; with `split`, a chain of
    per-device segments and collective steps (module docstring)."""
    return Compiled(fn, static_argnames, split)
