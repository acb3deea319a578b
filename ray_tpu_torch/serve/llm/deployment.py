"""LLMServer: the continuous-batching engine behind a plain callable, the
PyTorch counterpart of ``ray_tpu/serve/llm/deployment.py``.

The server owns one ``LLMEngine`` and one scheduler thread driving it;
``__call__`` (from any number of threads) submits into the engine's queue
inside an ``llm.server_call`` span and blocks on its handle, so
concurrent requests share the one decode batch. ``export_prefix`` and
``import_prefix`` are the two halves of a peer prefix pull. Binding it as
a Serve application (``build_llm_app``) and the prefix-index publisher
need the port's own runtime and are a later slice.
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
        """Cheap load snapshot: engine queue and busy slots."""
        s = self._engine.stats()
        return {
            "queued": s["queued"],
            "active_slots": s["active_slots"],
            "free_slots": s["num_slots"] - s["active_slots"],
            "lanes": s["queued_by_lane"],
        }

    def stats(self) -> Dict[str, Any]:
        out = self._engine.stats()
        out["quantize"] = self.quantize
        return out

    def check_health(self) -> None:
        if not self._thread.is_alive():
            raise RuntimeError("llm engine scheduler thread died")

    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop the scheduler thread and wait for it."""
        self._stop.set()
        self._engine._work.set()
        self._thread.join(timeout)

    def __del__(self):
        stop = getattr(self, "_stop", None)
        if stop is not None:
            stop.set()
