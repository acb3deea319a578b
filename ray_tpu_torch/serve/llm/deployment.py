"""LLMServer — the continuous-batching engine as a Serve replica: the
PyTorch counterpart of ``ray_tpu/serve/llm/deployment.py``.

Requests flow router -> replica -> engine: the replica actor hosts one
``LLMEngine`` plus a single scheduler thread driving it; ``__call__``
(which Serve runs concurrently up to ``max_ongoing_requests``) submits
into the engine's queue inside an ``llm.server_call`` span and blocks on
its handle, so concurrent requests share the one decode batch.
``export_prefix`` and ``import_prefix`` are the two halves of a peer
prefix pull; a paged replica with a prefix cache publishes its hash-chain
heads to the cluster-wide prefix index on a fixed period when its
process has a cluster attached. ``build_llm_app`` binds it as a Serve
application, its replicas on ``num_gpus`` of the card. The server also
runs in a plain process (``device="cpu"`` where there is no card).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Union

import torch


class LLMServer:
    """Owns the engine and its scheduler thread.

    ``model_config`` / ``engine_config`` may be the dataclasses or plain
    kwargs dicts. Weights: ``init_seed`` builds random params on the
    device (tests, smoke runs); ``params_loader``, a zero-arg callable
    returning the param tree on the device, is the production hook.
    ``quantize`` defaults to ``"int8"`` (weight-only, as in the reference's
    serve default); ``"bf16"`` opts out. The legacy ``quantize_int8=True``
    is honoured as a synonym for ``quantize="int8"``. ``device`` defaults
    to the card and raises where there is none.

    ``speculative`` arms speculative decoding (paged layout): True for
    the default draft (``disagg.spec.draft_config_for``, random weights
    from seed 0), or a dict with any of ``draft_seed``, ``draft_config``
    (a ``LlamaConfig`` or its kwargs) and ``params_loader`` (a zero-arg
    callable returning the draft's params on the device). The draft is
    not quantized, as in the reference.

    As a Serve replica it builds in the replica's process, on the card
    its lease names (``CUDA_VISIBLE_DEVICES``); a lease without a GPU
    raises unless ``device="cpu"`` is bound with the other arguments.
    """

    def __init__(self, model_config: Any = None,
                 engine_config: Any = None,
                 init_seed: int = 0,
                 params_loader: Optional[Any] = None,
                 quantize: Optional[str] = None,
                 quantize_int8: bool = False,
                 speculative: Any = None,
                 device: Optional[Union[str, torch.device]] = None):
        from ray_tpu_torch._private.device import resolve_device
        from ray_tpu_torch.models.llama import (
            LlamaConfig, init_params, quantize_weights_int8,
        )
        from ray_tpu_torch.serve.llm.engine import EngineConfig, LLMEngine

        dev = resolve_device(device)
        if model_config is None:
            model_config = LlamaConfig.tiny()
        elif isinstance(model_config, dict):
            model_config = LlamaConfig(**model_config)
        if engine_config is None:
            engine_config = EngineConfig()
        elif isinstance(engine_config, dict):
            engine_config = EngineConfig(**engine_config)

        if quantize is None:
            # The serve default, which quantize_int8=True also asks for.
            quantize = "int8"
        if quantize not in ("int8", "bf16"):
            raise ValueError(
                f"quantize must be 'int8' or 'bf16', got {quantize!r}")
        self.quantize = quantize

        if params_loader is not None:
            params = params_loader()
        else:
            params = init_params(model_config, init_seed, dev)
        if quantize == "int8":
            params = quantize_weights_int8(params)

        draft_params = draft_config = None
        if speculative:
            from ray_tpu_torch.serve.llm.disagg.spec import (
                build_draft, draft_config_for,
            )

            spec = speculative if isinstance(speculative, dict) else {}
            dc = spec.get("draft_config")
            if isinstance(dc, dict):
                dc = LlamaConfig(**dc)
            draft_config = dc or draft_config_for(model_config)
            loader = spec.get("params_loader")
            if loader is not None:
                draft_params = loader()
            else:
                draft_params, draft_config = build_draft(
                    model_config, seed=int(spec.get("draft_seed", 0)),
                    draft_config=draft_config, device=dev)

        self._engine = LLMEngine(params, model_config, engine_config,
                                 draft_params=draft_params,
                                 draft_config=draft_config, device=dev)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._engine.run, args=(self._stop,),
            name="llm-engine-scheduler", daemon=True)
        self._thread.start()

        # Cluster-wide prefix index: this replica's identity in the
        # GCS index (the router learns it from load()), plus the
        # publisher thread pushing hash-chain heads on a fixed period.
        # The publish IS the liveness signal — a dead replica ages out
        # of cache-aware routing at the index TTL.
        import uuid

        self._replica_id = uuid.uuid4().hex[:12]
        if getattr(self._engine, "_prefix", None) is not None:
            threading.Thread(
                target=self._publish_index_loop, daemon=True,
                name="llm-prefix-index-publish").start()

    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """request: {"prompt": [token ids], "max_tokens": int,
        "temperature": float, "stop": [token ids], "slo": lane,
        "chunked_prefill": bool, "tenant": str} ->
        completed tokens plus latency detail. Blocks the calling thread;
        the scheduler thread interleaves all concurrent requests. A wait
        past ``timeout_s`` is counted in ``serve_request_timeouts_total``
        and raises."""
        from ray_tpu_torch.observability.serve import serve_metrics
        from ray_tpu_torch.serve.llm.engine import Request
        from ray_tpu_torch.util.tracing import span

        # Submit INSIDE the span: the engine captures the submitting
        # thread's trace context, so llm.request parents under it.
        with span("llm.server_call",
                  attrs={"prompt_len": len(request["prompt"])}):
            handle = self._engine.submit(Request(
                prompt=list(request["prompt"]),
                max_tokens=int(request.get("max_tokens", 64)),
                temperature=float(request.get("temperature", 0.0)),
                stop=tuple(request.get("stop", ())),
                slo=str(request.get("slo", "interactive")),
                chunked_prefill=bool(request.get("chunked_prefill",
                                                 False)),
                tenant=str(request.get("tenant", "default"))))
            try:
                tokens = handle.result(timeout=float(
                    request.get("timeout_s", 300.0)))
            except TimeoutError:
                serve_metrics().request_timeouts.inc()
                raise
        return {
            "tokens": tokens,
            "num_tokens": len(tokens),
            "finish_reason": handle.finish_reason,
            "ttft_s": handle.ttft_s,
            "tpot_s": handle.tpot_s,
        }

    def _publish_index_loop(self) -> None:
        from ray_tpu_torch._private.config import GlobalConfig
        from ray_tpu_torch._private.worker import global_worker_or_none

        interval = float(
            GlobalConfig.serve_prefix_index_publish_interval_s)
        while not self._stop.wait(interval):
            w = global_worker_or_none()
            if w is None:
                continue        # no cluster: nothing to publish to
            try:
                eng = self._engine
                tiers: Dict[str, Any] = {
                    "block_size": eng.config.kv_block_size}
                if eng._tiers is not None:
                    ts = eng._tiers.stats()
                    tiers["host_blocks"] = ts["host"]["blocks"]
                    tiers["store_blocks"] = ts["store"]["blocks"]
                w.gcs.call("report_prefix_index", timeout=5,
                           replica=self._replica_id,
                           heads=eng.prefix_index_heads(),
                           tiers=tiers)
            except Exception:
                pass            # index is a hint; never crash a replica

    def export_prefix(self, tokens, max_blocks=None):
        """Donor side of a peer prefix pull: the longest pool + tier chain
        covering ``tokens`` as single-block KVPrefix links. Hops to the
        scheduler thread, the only one that reads device state."""
        return self._engine.call_on_scheduler(
            lambda: self._engine.export_prefix(tokens,
                                               max_blocks=max_blocks),
            timeout_s=30.0)

    def import_prefix(self, prefixes) -> int:
        """Receiver side of a peer prefix pull: park pulled links in the
        host tier; the pulling request's admission promotes them through
        the cost model. Thread-safe, no scheduler hop."""
        return self._engine.import_prefix(prefixes)

    def load(self) -> Dict[str, Any]:
        """Cheap load snapshot for the LLM router's queue-depth probe
        (serve/llm/router.py): engine queue and busy slots, safe to call
        at probe frequency. ``index_id`` is how the router joins this
        replica's handle to its GCS prefix-index entry."""
        s = self._engine.stats()
        return {
            "queued": s["queued"],
            "active_slots": s["active_slots"],
            "free_slots": s["num_slots"] - s["active_slots"],
            "lanes": s["queued_by_lane"],
            "index_id": self._replica_id,
        }

    def stats(self) -> Dict[str, Any]:
        from ray_tpu_torch.observability import jit_stats

        out = self._engine.stats()
        out["quantize"] = self.quantize
        out["jit"] = {k: v for k, v in jit_stats().items()
                      if k.startswith("llm_engine_")}
        return out

    def check_health(self) -> None:
        if not self._thread.is_alive():
            raise RuntimeError("llm engine scheduler thread died")

    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop the scheduler thread and the index publisher, and wait
        for the scheduler."""
        self._stop.set()
        self._engine._work.set()
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout)

    def __del__(self):
        # Serve's Replica.prepare_shutdown calls this before the kill.
        if getattr(self, "_thread", None) is not None:
            self.shutdown()
        elif getattr(self, "_stop", None) is not None:
            self._stop.set()


def build_llm_app(model_config: Any = None, engine_config: Any = None,
                  *, name: str = "llm", num_replicas: int = 1,
                  num_gpus: float = 0, max_ongoing_requests: int = 32,
                  init_seed: int = 0, quantize: Optional[str] = None,
                  quantize_int8: bool = False,
                  params_loader: Optional[Any] = None,
                  device: Optional[str] = None):
    """Bind LLMServer as a Serve application: one engine per replica,
    `max_ongoing_requests` concurrent submitters feeding its slot pool.
    Pass configs as dicts (e.g. ``{"num_slots": 8}``) or dataclasses.
    ``num_gpus`` is each replica's share of the card (a fraction puts
    several replicas on one card). ``quantize`` defaults to the int8
    serve config; pass "bf16" to opt out. ``device`` is bound with the
    rest (``"cpu"`` on a host without a card; None is the leased card).
    For N replicas behind a queue-depth-aware router, use
    ``serve.llm.build_routed_llm_app`` instead."""
    from ray_tpu_torch import serve

    if quantize is None and quantize_int8:
        quantize = "int8"
    dep = serve.deployment(
        LLMServer, name=name, num_replicas=num_replicas,
        num_gpus=num_gpus, max_ongoing_requests=max_ongoing_requests)
    return dep.bind(model_config=_plain(model_config),
                    engine_config=_plain(engine_config),
                    init_seed=init_seed, quantize=quantize,
                    params_loader=params_loader, **_device_kw(device))


def _device_kw(device: Any) -> Dict[str, Any]:
    """The bound ``device`` argument: left out when None, so the replica
    builds on the card its lease names."""
    return {} if device is None else {"device": str(device)}


def _plain(cfg: Any):
    """Dataclass -> dict so the spec cloudpickles as plain values (a
    ``torch.dtype`` field included); dicts/None pass through."""
    import dataclasses

    if cfg is None or isinstance(cfg, dict):
        return cfg
    if dataclasses.is_dataclass(cfg):
        return {f.name: getattr(cfg, f.name)
                for f in dataclasses.fields(cfg)}
    return cfg
