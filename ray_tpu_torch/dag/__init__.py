"""Static task/actor DAGs + compiled execution over mutable channels.

Reference: `python/ray/dag/` — `fn.bind(x)` / `actor.method.bind(x)`
build a lazy DAG around an `InputNode`; `dag.execute(x)` runs it as
ordinary tasks; `dag.experimental_compile()` (compiled_dag_node.py:141)
pre-wires the DAG over reusable shared-memory channels so repeated
executions bypass the per-call task path entirely.

On the port: a compiled DAG turns a fixed inference pipeline (e.g.
tokenize → prefill/decode on the GPU actor → detokenize) into ~100µs
channel hops instead of ~ms task RPCs, keeping the card fed. Unlike the
JAX package's, ``teardown()`` returns each stage loop's
``{"iterations": n}`` and raises if a loop failed.
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.experimental.channel import (
    Channel, ChannelClosedError, DEFAULT_BUFFER_SIZE,
)

COMPILED_STAGE_METHOD = "__rt_compiled_stage__"


class DAGNode:
    """Base: a lazily-bound computation with DAGNode/value args."""

    def __init__(self, args: Tuple = (), kwargs: Optional[Dict] = None):
        self._bound_args = tuple(args)
        self._bound_kwargs = dict(kwargs or {})
        self._id = uuid.uuid4().hex[:12]

    # ------------------------------------------------------------ traversal
    def _deps(self) -> List["DAGNode"]:
        out = []
        for a in list(self._bound_args) + list(self._bound_kwargs.values()):
            if isinstance(a, DAGNode):
                out.append(a)
        return out

    def _topo(self) -> List["DAGNode"]:
        order, seen = [], set()

        def visit(n: "DAGNode"):
            if n._id in seen:
                return
            seen.add(n._id)
            for d in n._deps():
                visit(d)
            order.append(n)

        visit(self)
        return order

    # ------------------------------------------------------------ execution
    def execute(self, *input_args, **input_kwargs):
        """Interpreted execution: one task/actor call per node.
        Returns ObjectRef(s) for the terminal node(s)."""
        input_value = _pack_input(input_args, input_kwargs)
        memo: Dict[str, Any] = {}
        for node in self._topo():
            memo[node._id] = node._execute_one(memo, input_value)
        return memo[self._id]

    def _execute_one(self, memo, input_value):
        raise NotImplementedError

    def _resolve(self, memo):
        args = [memo[a._id] if isinstance(a, DAGNode) else a
                for a in self._bound_args]
        kwargs = {k: memo[v._id] if isinstance(v, DAGNode) else v
                  for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def experimental_compile(
            self, _buffer_size_bytes: int = DEFAULT_BUFFER_SIZE,
            _max_in_flight: int = 2,
    ) -> "CompiledDAG":
        return CompiledDAG(self, _buffer_size_bytes, _max_in_flight)


class InputNode(DAGNode):
    """The DAG's runtime input. Usable as a context manager, matching the
    reference's `with InputNode() as inp:` idiom."""

    def __init__(self):
        super().__init__()

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def __getattr__(self, key: str) -> "InputAttributeNode":
        if key.startswith("_"):
            raise AttributeError(key)
        return InputAttributeNode(self, key, getattr)

    def __getitem__(self, key) -> "InputAttributeNode":
        return InputAttributeNode(self, key,
                                  lambda v, k: v[k])

    def _execute_one(self, memo, input_value):
        return input_value


class InputAttributeNode(DAGNode):
    """`inp.x` / `inp["x"]` — extracts a field of the input."""

    def __init__(self, parent: InputNode, key, extractor):
        super().__init__(args=(parent,))
        self._key = key
        self._extract = extractor

    def _execute_one(self, memo, input_value):
        return self._extract(input_value, self._key)


class FunctionNode(DAGNode):
    """`remote_fn.bind(...)` — a stateless task node."""

    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def _execute_one(self, memo, input_value):
        args, kwargs = self._resolve(memo)
        return self._remote_fn.remote(*args, **kwargs)


class ClassMethodNode(DAGNode):
    """`actor.method.bind(...)` — a stateful actor-method node."""

    def __init__(self, actor_method, args, kwargs):
        super().__init__(args, kwargs)
        self._method = actor_method

    @property
    def _actor_id(self) -> bytes:
        return self._method._handle._actor_id

    def _execute_one(self, memo, input_value):
        args, kwargs = self._resolve(memo)
        return self._method.remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Terminal fan-in: execute() returns one value per output."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(args=tuple(outputs))

    def _execute_one(self, memo, input_value):
        return [memo[o._id] for o in self._bound_args]


def _pack_input(args, kwargs):
    if kwargs or len(args) > 1:
        raise TypeError(
            "DAG input is a single value; pack multiple inputs in a "
            "dict/tuple and split with inp['key'] / inp[i]")
    return args[0] if args else None


# ---------------------------------------------------------------------------
# Compiled execution
# ---------------------------------------------------------------------------

_DRIVER = "__driver_input__"


class CompiledDAGRef:
    """Future for one compiled execution (reference: CompiledDAGRef).
    Results come off the shared output channels FIFO, so refs must be
    consumed in execution order — get() enforces it."""

    def __init__(self, dag: "CompiledDAG", multi: bool, idx: int):
        self._dag = dag
        self._multi = multi
        self._idx = idx
        # Partially-read outputs survive a timeout so a retry resumes on
        # the not-yet-read channels instead of mispairing executions.
        self._vals: List[Any] = []
        self._done = False

    def get(self, timeout: Optional[float] = 30.0):
        if not self._done:
            if self._dag._next_read_idx != self._idx:
                raise RuntimeError(
                    f"compiled DAG results are FIFO: this ref is execution "
                    f"#{self._idx} but #{self._dag._next_read_idx} is next; "
                    f"call get() on earlier refs first")
            chans = self._dag._output_channels
            while len(self._vals) < len(chans):
                self._vals.append(chans[len(self._vals)].read(timeout))
            self._dag._next_read_idx += 1
            self._done = True
        for v in self._vals:
            if isinstance(v, _StageError):
                raise v.error
        return self._vals if self._multi else self._vals[0]


class CompiledDAG:
    """The DAG pre-wired over shm channels: every actor node runs a
    resident stage loop; `execute()` = one channel write, `get()` = one
    channel read."""

    def __init__(self, root: DAGNode, buffer_size: int,
                 max_in_flight: int = 2):
        self._buffer_size = buffer_size
        # Every channel holds ONE slot, so unconsumed executions beyond
        # the pipeline depth would deadlock the driver's write. Cap them
        # (2 = one result pending + one execution in the pipe, always
        # within any DAG's slot budget).
        self._max_in_flight = max(1, max_in_flight)
        self._next_exec_idx = 0
        self._next_read_idx = 0
        self._torn_down = False
        self._stage_results: List[Dict[str, int]] = []
        self._channels: List[Channel] = []

        nodes = root._topo()
        outputs = (list(root._bound_args)
                   if isinstance(root, MultiOutputNode) else [root])
        stages = [n for n in nodes if isinstance(n, ClassMethodNode)]
        for n in nodes:
            if not isinstance(n, (InputNode, InputAttributeNode,
                                  ClassMethodNode, MultiOutputNode)):
                raise TypeError(
                    "experimental_compile supports actor-method nodes only "
                    f"(got {type(n).__name__}); stateless fn.bind nodes "
                    "run via dag.execute()")
        seen_actors = set()
        for s in stages:
            if s._actor_id in seen_actors:
                raise ValueError(
                    "compiled DAGs bind at most one method per actor "
                    "(the stage loop occupies the actor for the DAG's "
                    "lifetime)")
            seen_actors.add(s._actor_id)
        for o in outputs:
            if not isinstance(o, ClassMethodNode):
                raise TypeError("DAG outputs must be actor-method nodes")

        # producer keys: driver input = _DRIVER, else node id.
        def producer_key(dep: DAGNode) -> str:
            if isinstance(dep, (InputNode, InputAttributeNode)):
                return _DRIVER
            return dep._id

        # Channels are SPSC: one per (producer, consumer) pair, shared by
        # all args between that pair.
        chan: Dict[Tuple[str, str], Channel] = {}

        def channel_for(p: str, c: str) -> Channel:
            if (p, c) not in chan:
                ch = Channel(create=True, buffer_size=buffer_size)
                chan[(p, c)] = ch
                self._channels.append(ch)
            return chan[(p, c)]

        # Driver-input channels (one per consumer that reads the input).
        self._input_channels: List[Channel] = []
        payloads: Dict[str, Dict[str, Any]] = {}
        for s in stages:
            def spec_of(a):
                if isinstance(a, (InputNode, InputAttributeNode)):
                    key = getattr(a, "_key", None)
                    extract = getattr(a, "_extract", None)
                    return ("chan", _DRIVER, key, extract)
                if isinstance(a, ClassMethodNode):
                    return ("chan", a._id, None, None)
                if isinstance(a, DAGNode):
                    raise TypeError(f"unsupported dep {type(a).__name__}")
                return ("const", a)

            arg_spec = [spec_of(a) for a in s._bound_args]
            kwarg_spec = {k: spec_of(v)
                          for k, v in s._bound_kwargs.items()}
            in_channels = {}
            for sp in list(arg_spec) + list(kwarg_spec.values()):
                if sp[0] == "chan":
                    in_channels[sp[1]] = channel_for(sp[1], s._id)
            payloads[s._id] = {
                "method": s._method._name,
                "arg_spec": arg_spec,
                "kwarg_spec": kwarg_spec,
                "in_channels": in_channels,
                "out_channels": [],
            }
        for (p, c), ch in chan.items():
            if p == _DRIVER:
                self._input_channels.append(ch)
            else:
                payloads[p]["out_channels"].append(ch)

        # Terminal outputs feed the driver.
        self._output_channels = []
        for o in outputs:
            ch = Channel(create=True, buffer_size=buffer_size)
            self._channels.append(ch)
            payloads[o._id]["out_channels"].append(ch)
            self._output_channels.append(ch)

        self._multi = isinstance(root, MultiOutputNode)
        # Launch the resident stage loops (one dedicated actor task each).
        from ray_tpu_torch.actor import ActorMethod

        self._stage_refs = []
        for s in stages:
            loop_method = ActorMethod(s._method._handle,
                                      COMPILED_STAGE_METHOD)
            self._stage_refs.append(loop_method.remote(payloads[s._id]))

    # ------------------------------------------------------------------ api
    def execute(self, *args, _timeout: float = 30.0,
                **kwargs) -> CompiledDAGRef:
        if self._torn_down:
            raise RuntimeError("compiled DAG was torn down")
        if self._next_exec_idx - self._next_read_idx >= self._max_in_flight:
            raise RuntimeError(
                f"{self._max_in_flight} executions already in flight; "
                f"get() earlier results first (or raise _max_in_flight "
                f"at compile time)")
        value = _pack_input(args, kwargs)
        payload = Channel.serialize(value)   # once, even when fanning out
        for ch in self._input_channels:
            ch.write_serialized(payload, timeout=_timeout)
        ref = CompiledDAGRef(self, self._multi, self._next_exec_idx)
        self._next_exec_idx += 1
        return ref

    def teardown(self) -> List[Dict[str, int]]:
        """Close every channel, wait for the stage loops to return and
        give back what each returned (``{"iterations": n}``, in stage
        order); a stage loop that failed raises here, after the
        channels are released. A second call returns the same."""
        if self._torn_down:
            return self._stage_results
        self._torn_down = True
        import ray_tpu_torch

        for ch in self._channels:
            ch.close()
        try:
            self._stage_results = ray_tpu_torch.get(self._stage_refs,
                                                    timeout=10)
        finally:
            for ch in self._channels:
                ch.release()
        return self._stage_results

    def __del__(self):  # pragma: no cover
        try:
            self.teardown()
        except Exception:
            pass


class _StageError:
    """An exception crossing channels: downstream stages forward it
    untouched and CompiledDAGRef.get() re-raises it on the driver, so a
    failing stage degrades to a per-execution error instead of a hung
    pipeline."""

    def __init__(self, error: Exception):
        self.error = error


def run_compiled_stage(instance, payload: Dict[str, Any]) -> Dict[str, int]:
    """Executes one node's resident loop inside its actor (dispatched by
    the worker when it sees COMPILED_STAGE_METHOD). Blocks the actor's
    executor until teardown — compiled DAGs own their actors, matching
    the reference's aDAG semantics."""
    in_channels: Dict[str, Channel] = payload["in_channels"]
    out_channels: List[Channel] = payload["out_channels"]
    iterations = 0
    # A bad method name must not strand the protocol: keep the loop
    # alive and answer every execution with the error instead.
    fatal: Optional[_StageError] = None
    method = getattr(instance, payload["method"], None)
    if method is None:
        fatal = _StageError(AttributeError(
            f"actor has no method {payload['method']!r}"))

    def build(spec, vals):
        if spec[0] == "const":
            return spec[1]
        _, pkey, key, extract = spec
        v = vals[pkey]
        return extract(v, key) if extract is not None else v

    try:
        while True:
            try:
                vals = {k: ch.read() for k, ch in in_channels.items()}
            except ChannelClosedError:
                break
            upstream_err = next((v for v in vals.values()
                                 if isinstance(v, _StageError)), None)
            if fatal is not None:
                result = fatal
            elif upstream_err is not None:
                result = upstream_err
            else:
                try:
                    args = [build(sp, vals) for sp in payload["arg_spec"]]
                    kwargs = {k: build(sp, vals)
                              for k, sp in payload["kwarg_spec"].items()}
                    result = method(*args, **kwargs)
                except Exception as e:  # noqa: BLE001
                    result = _StageError(e)
            closed = False
            for ch in out_channels:
                try:
                    ch.write(result)
                except ChannelClosedError:
                    closed = True
                    break
                except Exception as e:  # noqa: BLE001
                    # Oversized / unpicklable result: the error (small,
                    # picklable) takes the value's slot so this execution
                    # fails instead of the whole pipeline wedging.
                    try:
                        ch.write(_StageError(e))
                    except Exception:
                        closed = True
                        break
            if closed:
                break
            iterations += 1
    finally:
        for ch in list(in_channels.values()) + out_channels:
            ch.close()
    return {"iterations": iterations}


__all__ = [
    "DAGNode", "InputNode", "InputAttributeNode", "FunctionNode",
    "ClassMethodNode", "MultiOutputNode", "CompiledDAG", "CompiledDAGRef",
]
