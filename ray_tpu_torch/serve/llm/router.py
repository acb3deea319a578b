"""LLM request router — queue-depth-aware spreading across replicas: the
port's copy of ``ray_tpu/serve/llm/router.py``.

The generic handle router (serve/_private/router.py) balances on its own
*local* in-flight counts: enough when every caller owns a private view
of load, blind when load hides inside the replicas — an LLM replica
admits requests into its engine queue, so two replicas can report equal
in-flight counts while one sits on a deep prefill backlog. This router
is a *deployment* in front of N ``LLMServer`` replicas that closes that
gap:

- a probe thread samples every replica's engine (`LLMServer.load`) on a
  short period, capturing queued + active work the handle layer cannot
  see (exported as ``rtpu_serve_router_queue_depth{replica=...}``);
- request assignment is power-of-two-choices over (local in-flight +
  probed engine depth), so a stalled or backlogged replica sheds
  traffic within one probe period instead of one long-poll;
- the router pushes its total in-flight to the controller
  (`record_handle_metrics`) exactly like a handle does, so the
  ``AutoscalePolicy`` inflight law — and its queue-wait/utilization
  signals from the replicas' own gauges — keep steering replica count
  with no new plumbing.

Cache-aware routing (cluster-wide KV memory hierarchy): replicas
publish their prefix hash-chain heads to a GCS index
(``report_prefix_index``); an index thread here polls
``lookup_prefix_index`` on the same period. A decode pick then scores
``load - serve_router_cache_weight * expected_hit_blocks``, where the
expected hit is the longest run of the prompt's block-boundary
``stable_hash_prefix`` values present in a replica's published heads —
p2c with a thumb on the scale for KV the replica already holds. The
index is a hint with the controllers' staleness discipline: if its view is
older than ``serve_prefix_index_ttl_s`` it HOLDs to plain p2c rather
than chase dead cache state. When the loser of the pick holds
``serve_peer_pull_min_blocks`` more cached blocks than the winner, the
router pulls those blocks winner-ward first (donor ``export_prefix`` ->
chosen ``import_prefix``, payload by ObjectRef, store-to-store) so the
pick's admission promotes them instead of re-prefilling.

``build_routed_llm_app`` composes Router(LLM): the inner LLM deployment
scales (fixed N or ``num_replicas="auto"`` via autoscaling_config), the
router stays a single cheap replica. The engine replicas lease
``num_gpus`` of the card each; the router leases none, and the KV
payloads of a two-hop request and of a peer pull never enter its
process (it forwards ObjectRefs), so it never touches CUDA. A replica
appears in metric tags and in ``stats()`` under the hex of its actor id
(:func:`replica_tag`), free of the ``,`` that a metric tag may not hold.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["LLMRouter", "build_routed_llm_app", "p2c_pick", "replica_tag"]


def replica_tag(replica: Any) -> str:
    """A replica's name in metric tags and ``stats()``: the hex of its
    actor id (the raw id is bytes, whose repr may hold a ``,``)."""
    rid = getattr(replica, "_actor_id", None)
    if isinstance(rid, (bytes, bytearray)):
        return bytes(rid).hex()
    return str(id(replica) if rid is None else rid).replace(",", "_")


def p2c_pick(replicas: Sequence[Any], load: Dict[Any, float],
             rng: Optional[random.Random] = None) -> Any:
    """Power-of-two-choices over an explicit load view: sample two
    distinct replicas, keep the lighter one. Pure — the routing policy
    under test, separated from the actor plumbing."""
    if not replicas:
        raise RuntimeError("no replicas to pick from")
    if len(replicas) == 1:
        return replicas[0]
    rng = rng or random
    a, b = rng.sample(list(replicas), 2)
    return a if load.get(a, 0.0) <= load.get(b, 0.0) else b


class LLMRouter:
    """Deployment callable fronting the ``LLMServer`` deployment.

    Constructed via composition — ``build_routed_llm_app`` binds the
    inner LLM app as an init argument, which Serve rehydrates into a
    :class:`~ray_tpu_torch.serve.handle.DeploymentHandle` inside the router
    replica. The router reads the handle's target coordinates and talks
    to the replica set directly (same controller surface the generic
    router uses), because per-replica probing needs replica identity,
    which the handle layer abstracts away.
    """

    def __init__(self, llm_handle: Any,
                 probe_interval_s: Optional[float] = None,
                 prefill_handle: Any = None,
                 prefill_threshold: int = 256):
        from ray_tpu_torch._private.config import GlobalConfig
        from ray_tpu_torch.observability import serve_metrics

        self._app = llm_handle._app
        self._deployment = llm_handle._deployment
        self._probe_interval = (
            GlobalConfig.serve_router_probe_interval_s
            if probe_interval_s is None else probe_interval_s)
        self._replicas: List[Any] = []
        self._version = -1
        self._inflight: Dict[Any, int] = {}
        self._depth: Dict[Any, float] = {}     # probed engine depth
        self._routed: Dict[str, int] = {}      # per-replica forward count
        self._lane_routed: Dict[Tuple[str, str], int] = {}
        # Optional prefill pool (serve/llm/disagg): prompts at or past
        # `prefill_threshold` tokens take the two-hop path — prefill
        # replica exports KV, decode replica adopts it; the prefill
        # result moves between them by ObjectRef (store-to-store).
        self._pre_app = self._pre_deployment = None
        self._pre_threshold = int(prefill_threshold)
        self._pre_replicas: List[Any] = []
        self._pre_version = -1
        self._pre_inflight: Dict[Any, int] = {}
        self._pre_depth: Dict[Any, float] = {}
        if prefill_handle is not None:
            self._pre_app = prefill_handle._app
            self._pre_deployment = prefill_handle._deployment
        # Cluster prefix index view: replica index_id (from load()) ->
        # {"heads": [(stable_hash, depth)...], "tiers": {...},
        #  "age_s": float}, plus when WE last fetched it (HOLD clock).
        self._index: Dict[str, Dict[str, Any]] = {}
        self._index_at: float = 0.0            # monotonic, 0 = never
        self._index_id: Dict[Any, str] = {}    # handle -> index_id
        self._cache_weight = float(GlobalConfig.serve_router_cache_weight)
        self._index_ttl = float(GlobalConfig.serve_prefix_index_ttl_s)
        self._pull_min = int(GlobalConfig.serve_peer_pull_min_blocks)
        self._cache_outcomes: Dict[str, int] = {
            "scored": 0, "held": 0, "pulled": 0}
        self._last_expected: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._metrics = serve_metrics()
        import uuid

        self._router_id = uuid.uuid4().hex[:12]

        from ray_tpu_torch.serve._private.controller import (
            get_or_create_controller,
        )
        import ray_tpu_torch

        self._controller = get_or_create_controller()
        version, replicas = ray_tpu_torch.get(
            self._controller.get_replicas.remote(self._app,
                                                 self._deployment),
            timeout=60)
        self._apply(version, replicas)
        if self._pre_app is not None:
            version, replicas = ray_tpu_torch.get(
                self._controller.get_replicas.remote(
                    self._pre_app, self._pre_deployment),
                timeout=60)
            self._apply_prefill(version, replicas)
        for target, name in ((self._poll_loop, "llm-router-poll"),
                             (self._probe_loop, "llm-router-probe"),
                             (self._push_loop, "llm-router-push"),
                             (self._index_loop, "llm-router-index")):
            threading.Thread(target=target, daemon=True,
                             name=name).start()

    # ------------------------------------------------------------- replica set
    def _apply(self, version: int, replicas: List[Any]) -> None:
        with self._lock:
            if version != self._version:
                self._version = version
                self._replicas = replicas
                self._inflight = {r: self._inflight.get(r, 0)
                                  for r in replicas}
                self._depth = {r: self._depth.get(r, 0.0)
                               for r in replicas}

    def _apply_prefill(self, version: int, replicas: List[Any]) -> None:
        with self._lock:
            if version != self._pre_version:
                self._pre_version = version
                self._pre_replicas = replicas
                self._pre_inflight = {r: self._pre_inflight.get(r, 0)
                                      for r in replicas}
                self._pre_depth = {r: self._pre_depth.get(r, 0.0)
                                   for r in replicas}

    def _poll_loop(self) -> None:
        import ray_tpu_torch

        while not self._closed:
            try:
                version, replicas = ray_tpu_torch.get(
                    self._controller.poll_replicas.remote(
                        self._app, self._deployment, self._version, 25.0),
                    timeout=60)
                self._apply(version, replicas)
                if self._pre_app is not None:
                    version, replicas = ray_tpu_torch.get(
                        self._controller.poll_replicas.remote(
                            self._pre_app, self._pre_deployment,
                            self._pre_version, 0.5),
                        timeout=60)
                    self._apply_prefill(version, replicas)
            except Exception:
                if self._closed:
                    return
                time.sleep(1.0)

    # ------------------------------------------------------------- probing
    def _probe_one(self, r: Any) -> Tuple[float, Optional[str]]:
        import ray_tpu_torch

        try:
            load = ray_tpu_torch.get(
                r.handle_request.remote("load", (), {}),
                timeout=min(5.0, self._probe_interval * 5))
            return (float(load.get("queued", 0)
                          + load.get("active_slots", 0)),
                    load.get("index_id"))
        except Exception:
            # Unreachable/stalled replica: poison its score so
            # traffic shifts away until it answers again.
            return float("inf"), None

    def _probe_loop(self) -> None:
        while not self._closed:
            with self._lock:
                replicas = list(self._replicas)
                pre = list(self._pre_replicas)
            for r in replicas:
                depth, index_id = self._probe_one(r)
                with self._lock:
                    if r in self._depth:
                        self._depth[r] = depth
                    if index_id:
                        self._index_id[r] = str(index_id)
                if depth != float("inf"):
                    self._metrics.router_queue_depth.set(
                        depth, tags={"replica": replica_tag(r)})
            for r in pre:
                depth, _ = self._probe_one(r)
                with self._lock:
                    if r in self._pre_depth:
                        self._pre_depth[r] = depth
            time.sleep(self._probe_interval)

    def _index_loop(self) -> None:
        """Poll the GCS cluster prefix index on the publish period; a
        fetch failure just ages the view until the TTL HOLD trips."""
        from ray_tpu_torch._private.config import GlobalConfig
        from ray_tpu_torch._private.worker import global_worker_or_none

        interval = float(
            GlobalConfig.serve_prefix_index_publish_interval_s)
        while not self._closed:
            w = global_worker_or_none()
            if w is not None:
                try:
                    idx = w.gcs.call("lookup_prefix_index", timeout=5)
                    with self._lock:
                        self._index = dict(idx or {})
                        self._index_at = time.monotonic()
                except Exception:
                    pass
            with self._lock:
                at = self._index_at
            if at:
                self._metrics.router_index_age.set(
                    time.monotonic() - at)
            time.sleep(interval)

    def _index_age_s(self) -> float:
        with self._lock:
            at = self._index_at
        return (time.monotonic() - at) if at else float("inf")

    def _push_loop(self) -> None:
        """Handle-metrics push: the autoscaler's inflight law sees the
        router's total exactly as it would a plain handle's."""
        while not self._closed:
            time.sleep(2.0)
            with self._lock:
                total = sum(self._inflight.values())
            try:
                self._controller.record_handle_metrics.remote(
                    self._app, self._deployment, self._router_id, total)
            except Exception:
                return

    # ------------------------------------------------------------- routing
    def _score(self, pool: str = "decode") \
            -> Tuple[List[Any], Dict[Any, float]]:
        with self._lock:
            if pool == "prefill":
                replicas = list(self._pre_replicas)
                load = {r: self._pre_inflight.get(r, 0)
                        + self._pre_depth.get(r, 0.0) for r in replicas}
            else:
                replicas = list(self._replicas)
                load = {r: self._inflight.get(r, 0)
                        + self._depth.get(r, 0.0) for r in replicas}
        return replicas, load

    def _expected_hits(self, prompt: Sequence[int]) -> Dict[str, int]:
        """Per-replica expected prefix hit, in blocks: the longest run
        of this prompt's block-boundary stable hashes present in the
        replica's published heads. Pure function of the index snapshot —
        consumers on the replica re-verify against real tokens, so a
        stable-hash collision here only mis-scores, never corrupts."""
        from ray_tpu_torch.serve.llm.kv_cache import stable_hash_prefix

        with self._lock:
            index = dict(self._index)
        out: Dict[str, int] = {}
        bound_cache: Dict[int, List[int]] = {}  # block_size -> hashes
        for iid, rec in index.items():
            try:
                bs = int(rec.get("tiers", {}).get("block_size", 0))
            except Exception:
                bs = 0
            if bs <= 0:
                continue
            if bs not in bound_cache:
                # Last token never lands in a cached block (it must be
                # prefilled to produce logits) — same cap as admission.
                n_bound = max(0, (len(prompt) - 1) // bs)
                bound_cache[bs] = [
                    stable_hash_prefix(prompt[:j * bs])
                    for j in range(1, n_bound + 1)]
            heads = {int(h) for h, _d in rec.get("heads", ())}
            n = 0
            for h in bound_cache[bs]:
                if h not in heads:
                    break
                n += 1
            out[iid] = n
        return out

    def _pick(self, pool: str) -> Any:
        deadline = time.monotonic() + 30.0
        replicas, load = self._score(pool)
        while not replicas:
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"no live {pool} replicas for "
                    f"{self._app}/{self._deployment}")
            time.sleep(0.05)
            replicas, load = self._score(pool)
        return p2c_pick(replicas, load)

    def _pick_cached(self, prompt: Sequence[int]) \
            -> Tuple[Any, Dict[str, int], str]:
        """Decode pick with the cluster prefix index applied. Returns
        (chosen, expected_hits_by_index_id, outcome) where outcome is
        "scored" (index applied) or "held" (stale/absent index -> plain
        p2c, the controllers' staleness discipline)."""
        deadline = time.monotonic() + 30.0
        while True:
            replicas, load = self._score("decode")
            if replicas:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"no live decode replicas for "
                    f"{self._app}/{self._deployment}")
            time.sleep(0.05)
        stale = self._index_age_s() > self._index_ttl
        if stale or self._cache_weight <= 0.0 or not prompt:
            return p2c_pick(replicas, load), {}, "held"
        expected = self._expected_hits(prompt)
        if not expected:
            return p2c_pick(replicas, load), {}, "held"
        with self._lock:
            ids = dict(self._index_id)
        adj = {r: load.get(r, 0.0)
               - self._cache_weight * expected.get(ids.get(r), 0)
               for r in replicas}
        return p2c_pick(replicas, adj), expected, "scored"

    def _maybe_peer_pull(self, chosen: Any, prompt: Sequence[int],
                         expected: Dict[str, int],
                         timeout: float) -> bool:
        """If some OTHER replica holds serve_peer_pull_min_blocks more
        of this prompt's prefix than the chosen one, pull its chain into
        the chosen replica's host tier before forwarding, so admission
        promotes instead of re-prefilling. Synchronous on purpose — the
        import must land before the request does. Best-effort: any
        failure falls back to plain recompute on the chosen replica."""
        import ray_tpu_torch

        with self._lock:
            ids = dict(self._index_id)
            replicas = list(self._replicas)
        mine = expected.get(ids.get(chosen), 0)
        donor, donor_hits = None, mine
        for r in replicas:
            if r is chosen:
                continue
            hits = expected.get(ids.get(r), 0)
            if hits > donor_hits:
                donor, donor_hits = r, hits
        if donor is None or donor_hits - mine < self._pull_min:
            return False
        try:
            from ray_tpu_torch.util.tracing import record_span

            # export ref flows donor -> store -> chosen; the Replica
            # layer materializes ObjectRef args in the chosen process.
            t0 = time.time()
            ref = donor.handle_request.remote(
                "export_prefix", (list(prompt),), {})
            n = ray_tpu_torch.get(
                chosen.handle_request.remote(
                    "import_prefix", (ref,), {}),
                timeout=min(30.0, timeout))
            if n:
                # Ambient context: the serve.request root is active on
                # this thread, so the span parents there.
                record_span("kv.peer_pull", t0, time.time() - t0,
                            attrs={"blocks": int(n)})
            return bool(n)
        except Exception:
            return False

    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Route one request under a fresh trace: ``serve.request`` is
        the trace root (the tail-sampling trigger), every hop below —
        ``serve.replica_call`` / ``serve.prefill_call`` / ``kv.*`` and
        the replica's spans across the process boundary — parents into
        one causal tree, and the response carries ``x-trace-id`` so the
        caller can fetch it back via ``util.state.get_trace``."""
        from ray_tpu_torch.util.tracing import trace_root

        lane = str(request.get("slo", "interactive"))
        tenant = str(request.get("tenant", "default"))
        with trace_root("serve.request",
                        attrs={"lane": lane,
                               "tenant": tenant,
                               "prompt_len": len(request.get(
                                   "prompt", ()))},
                        baggage={"slo": lane}) as tc:
            out = self._route(request)
        return dict(out) | {"x-trace-id": tc.trace_id}

    def _route(self, request: Dict[str, Any]) -> Dict[str, Any]:
        import ray_tpu_torch
        from ray_tpu_torch.util.tracing import span

        lane = str(request.get("slo", "interactive"))
        prompt = request.get("prompt", ())
        two_hop = (self._pre_app is not None
                   and len(prompt) >= self._pre_threshold)
        chosen, expected, outcome = self._pick_cached(prompt)
        rid = replica_tag(chosen)
        pre = self._pick("prefill") if two_hop else None
        with self._lock:
            self._inflight[chosen] = self._inflight.get(chosen, 0) + 1
            self._routed[rid] = self._routed.get(rid, 0) + 1
            key = (lane, "prefill" if two_hop else
                   ("decode" if self._pre_app is not None
                    else "monolithic"))
            self._lane_routed[key] = self._lane_routed.get(key, 0) + 1
            if pre is not None:
                self._pre_inflight[pre] = \
                    self._pre_inflight.get(pre, 0) + 1
        self._metrics.router_requests.inc(tags={"replica": rid})
        self._metrics.router_lane_requests.inc(
            tags={"lane": key[0], "pool": key[1]})
        self._metrics.router_cache_hops.inc(tags={"outcome": outcome})
        with self._lock:
            self._cache_outcomes[outcome] = \
                self._cache_outcomes.get(outcome, 0) + 1
            if outcome == "scored":
                self._last_expected = dict(expected)
        try:
            timeout = float(request.get("timeout_s", 300.0))
            # Peer pull: only on the single-hop path (two-hop already
            # moves KV prefill->decode) and only off a scored pick.
            if (outcome == "scored" and not two_hop
                    and self._maybe_peer_pull(chosen, prompt, expected,
                                              timeout)):
                self._metrics.router_cache_hops.inc(
                    tags={"outcome": "pulled"})
                with self._lock:
                    self._cache_outcomes["pulled"] = \
                        self._cache_outcomes.get("pulled", 0) + 1
            if two_hop:
                # Two-hop disaggregated path. The prefill result — KV
                # blocks included — is forwarded as an ObjectRef: the
                # decode replica materializes it from the object store
                # (Replica.handle_request's ObjectRef-arg resolution),
                # so the payload never enters the router process.
                with span("serve.prefill_call",
                          attrs={"replica": replica_tag(pre)}):
                    prefill_ref = pre.handle_request.remote(
                        "prefill", (request,), {})
                with span("serve.replica_call",
                          attrs={"replica": rid, "hop": "adopt"}):
                    return ray_tpu_torch.get(
                        chosen.handle_request.remote(
                            "adopt", (prefill_ref, request), {}),
                        timeout=timeout)
            with span("serve.replica_call", attrs={"replica": rid}):
                return ray_tpu_torch.get(
                    chosen.handle_request.remote(
                        "__call__", (request,), {}),
                    timeout=timeout)
        finally:
            with self._lock:
                if chosen in self._inflight:
                    self._inflight[chosen] -= 1
                if pre is not None and pre in self._pre_inflight:
                    self._pre_inflight[pre] -= 1

    # ------------------------------------------------------------- inspection
    def stats(self) -> Dict[str, Any]:
        age = self._index_age_s()
        with self._lock:
            out = {
                "cache_index": {
                    # inf -> None so the dict stays JSON-serializable
                    # for the dashboard rollup.
                    "age_s": (None if age == float("inf")
                              else round(age, 3)),
                    "fresh": age <= self._index_ttl,
                    "ttl_s": self._index_ttl,
                    "weight": self._cache_weight,
                    "replicas_indexed": len(self._index),
                    "outcomes": dict(self._cache_outcomes),
                    "expected_hit_blocks": dict(self._last_expected),
                },
                "replicas": len(self._replicas),
                "inflight": sum(self._inflight.values()),
                "routed": dict(self._routed),
                "lanes": {f"{lane}/{pool}": n for (lane, pool), n
                          in self._lane_routed.items()},
                "depth": {replica_tag(r): d
                          for r, d in self._depth.items()},
            }
            if self._pre_app is not None:
                out["prefill_pool"] = {
                    "replicas": len(self._pre_replicas),
                    "inflight": sum(self._pre_inflight.values()),
                    "threshold": self._pre_threshold,
                    "depth": {replica_tag(r): d
                              for r, d in self._pre_depth.items()},
                }
            return out

    def check_health(self) -> None:
        if self._closed:
            raise RuntimeError("router closed")

    def __del__(self):
        try:
            self._closed = True
        except Exception:
            pass


def build_routed_llm_app(model_config: Any = None,
                         engine_config: Any = None, *,
                         name: str = "llm",
                         num_replicas: Any = 2,
                         autoscaling_config: Optional[Dict[str, Any]] = None,
                         num_gpus: float = 0,
                         max_ongoing_requests: int = 32,
                         init_seed: int = 0,
                         quantize: Optional[str] = None,
                         params_loader: Optional[Any] = None,
                         probe_interval_s: Optional[float] = None,
                         device: Optional[str] = None):
    """Router(LLM) composition: N engine replicas behind one
    queue-depth-aware router. ``num_replicas`` may be an int or
    ``"auto"`` (with ``autoscaling_config``) — the autoscaler then
    drives the inner deployment while the router re-discovers the
    replica set through its controller poll. ``num_gpus`` is each
    engine replica's share of the card (0.5 puts two on one card); the
    router leases none. ``device`` is bound with the engine replicas'
    arguments (``"cpu"`` on a host without a card)."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm.deployment import (
        LLMServer, _device_kw, _plain,
    )

    llm_kwargs: Dict[str, Any] = dict(
        name=name, num_gpus=num_gpus,
        max_ongoing_requests=max_ongoing_requests)
    if num_replicas == "auto" or autoscaling_config is not None:
        llm_kwargs["num_replicas"] = num_replicas
        if autoscaling_config is not None:
            llm_kwargs["autoscaling_config"] = autoscaling_config
    else:
        llm_kwargs["num_replicas"] = int(num_replicas)
    llm_dep = serve.deployment(LLMServer, **llm_kwargs)
    llm_app = llm_dep.bind(model_config=_plain(model_config),
                           engine_config=_plain(engine_config),
                           init_seed=init_seed, quantize=quantize,
                           params_loader=params_loader,
                           **_device_kw(device))
    router_dep = serve.deployment(
        LLMRouter, name=f"{name}-router", num_replicas=1,
        max_ongoing_requests=max(64, max_ongoing_requests * 4))
    return router_dep.bind(llm_app, probe_interval_s=probe_interval_s)
