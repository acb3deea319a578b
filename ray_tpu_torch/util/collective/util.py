"""Rendezvous + hub actor for collective groups: the port's copy of
``ray_tpu/util/collective/util.py``.

Role-equivalent to the reference's ``NCCLUniqueIDStore`` named actor
(``util/collective/util.py:9``, ``nccl_collective_group.py:28,573``):
group members find each other through a named actor. The same actor also
implements the SHM backend's data plane (gather-reduce-scatter rounds),
host-level send/recv mailboxes, and carries the ``cuda`` backend's
workspace handles. Payloads are numpy arrays, CPU tensors or bytes.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.util.collective.types import ReduceOp


def _reduce(arrays: List[np.ndarray], op: ReduceOp) -> np.ndarray:
    stack = np.stack([np.asarray(a) for a in arrays])
    if op == ReduceOp.SUM:
        return stack.sum(axis=0)
    if op == ReduceOp.PRODUCT:
        return stack.prod(axis=0)
    if op == ReduceOp.MIN:
        return stack.min(axis=0)
    if op == ReduceOp.MAX:
        return stack.max(axis=0)
    if op == ReduceOp.AVERAGE:
        return stack.mean(axis=0)
    raise ValueError(f"unsupported reduce op {op}")


@ray_tpu_torch.remote(max_concurrency=256)
class CollectiveCoordinator:
    """Named async actor: rendezvous KV + SHM-backend collective hub.

    One instance per group, named ``collective_group:{group_name}``.
    """

    def __init__(self, world_size: int):
        self.world_size = world_size
        self.kv: Dict[str, Any] = {}
        self.kv_events: Dict[str, asyncio.Event] = {}
        # op_uid -> {"data": {rank: payload}, "event": Event, "result": Any}
        self.rounds: Dict[str, Dict] = {}
        # (src, dst, tag) -> payload mailboxes for send/recv
        self.mailboxes: Dict[tuple, Any] = {}
        self.mail_events: Dict[tuple, asyncio.Event] = {}
        # rank -> times it joined: a group re-made under the same name
        # keys its rounds and addresses by this generation, so nothing of
        # an earlier incarnation (a partial round, an old address) is
        # read again.
        self.joins: Dict[int, int] = {}

    async def join(self, rank: int) -> int:
        self.joins[rank] = self.joins.get(rank, 0) + 1
        return self.joins[rank]

    # ---- rendezvous KV ----------------------------------------------------
    async def put(self, key: str, value: Any):
        self.kv[key] = value
        self.kv_events.setdefault(key, asyncio.Event()).set()
        return True

    async def get(self, key: str, timeout: float = 60.0):
        ev = self.kv_events.setdefault(key, asyncio.Event())
        if key not in self.kv:
            try:
                await asyncio.wait_for(ev.wait(), timeout)
            except asyncio.TimeoutError:
                return None
        return self.kv.get(key)

    # ---- collective rounds (SHM backend data plane) -----------------------
    def _round(self, op_uid: str) -> Dict:
        if op_uid not in self.rounds:
            self.rounds[op_uid] = {"data": {}, "event": asyncio.Event(),
                                   "result": None}
        return self.rounds[op_uid]

    async def gather_round(self, op_uid: str, rank: int, payload: Any,
                           timeout: float = 300.0) -> Dict[int, Any]:
        """All ranks contribute; every caller gets the full {rank: payload}."""
        rnd = self._round(op_uid)
        rnd["data"][rank] = payload
        if len(rnd["data"]) == self.world_size:
            rnd["event"].set()
        else:
            try:
                await asyncio.wait_for(rnd["event"].wait(), timeout)
            except asyncio.TimeoutError:
                missing = sorted(set(range(self.world_size))
                                 - set(rnd["data"]))
                raise TimeoutError(
                    f"collective round {op_uid!r}: ranks {missing} did not "
                    f"arrive within {timeout} s") from None
        data = rnd["data"]
        # Last rank to observe completion cleans up.
        rnd.setdefault("seen", set()).add(rank)
        if len(rnd["seen"]) == self.world_size:
            self.rounds.pop(op_uid, None)
        return data

    async def barrier(self, op_uid: str, rank: int, timeout: float = 300.0):
        await self.gather_round(op_uid, rank, None, timeout)
        return True

    # ---- send/recv mailboxes ---------------------------------------------
    async def send(self, src: int, dst: int, tag: str, payload: Any):
        key = (src, dst, tag)
        self.mailboxes[key] = payload
        self.mail_events.setdefault(key, asyncio.Event()).set()
        return True

    async def recv(self, src: int, dst: int, tag: str,
                   timeout: float = 300.0):
        key = (src, dst, tag)
        ev = self.mail_events.setdefault(key, asyncio.Event())
        if key not in self.mailboxes:
            await asyncio.wait_for(ev.wait(), timeout)
        payload = self.mailboxes.pop(key)
        self.mail_events.pop(key, None)
        return payload


def get_or_create_coordinator(group_name: str, world_size: int):
    """Named-actor rendezvous: first caller creates, others attach. The
    hub holds no CPU (an actor of the port's runtime holds one by
    default), so groups made and destroyed over a cluster's life never
    starve its members of slots; like the reference's, it lives until the
    cluster ends."""
    name = f"collective_group:{group_name}"
    return CollectiveCoordinator.options(
        name=name, get_if_exists=True, lifetime="detached",
        max_concurrency=256, num_cpus=0).remote(world_size)
