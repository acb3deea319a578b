"""DecodeServer — the decode half of a disaggregated LLM tier: the port's
copy of ``ray_tpu/serve/llm/disagg/decode.py``.

An ``LLMServer`` (so it still serves plain ``__call__`` traffic — short
interactive prompts go straight here, where their prefill is cheap) plus
``adopt``: take a :class:`PrefillServer` result, import its KV blocks
into this engine's pool, and decode to completion. The LLM router passes
that result by object reference between replicas (the replica gets it
from the store, its tensors views of the stored object, which adoption
only reads), or a caller passes the dict in-process.
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.serve.llm.deployment import LLMServer

__all__ = ["DecodeServer"]


class DecodeServer(LLMServer):
    """Deployment callable for the decode pool. Engine config should
    lean decode-shaped: many slots, ``prefix_cache=True`` so adopted
    prompts stay warm for lookalikes, and optionally a draft model
    (``speculative=...``) — speculative decoding is the decode pool's
    raw speed lever and composes with adoption (the draft cache is
    re-seeded from the adopted prompt)."""

    def adopt(self, prefill_result: Dict[str, Any],
              request: Dict[str, Any]) -> Dict[str, Any]:
        """Continue a prefilled request: adopt its exported KVState and
        decode until finish. Returns the same response dict as
        ``__call__``; TTFT fields come from the prefill side of the
        migration (the first token was sampled there)."""
        from ray_tpu_torch.observability import serve_metrics
        from ray_tpu_torch.serve.llm.disagg.transfer import KVImporter
        from ray_tpu_torch.serve.llm.engine import Request
        from ray_tpu_torch.util.tracing import span

        if prefill_result["done"]:
            return prefill_result["response"]
        state = prefill_result["kv_state"]
        req = Request(
            prompt=list(request["prompt"]),
            max_tokens=int(request.get("max_tokens", 64)),
            temperature=float(request.get("temperature", 0.0)),
            stop=tuple(request.get("stop", ())),
            slo=str(request.get("slo", "interactive")),
            tenant=str(request.get("tenant", "default")))
        with span("llm.disagg_decode",
                  attrs={"prompt_len": len(req.prompt),
                         "adopted_blocks": state.n_blocks}):
            handle = KVImporter(self._engine).adopt(
                req, state,
                meter_snapshot=prefill_result.get("meter"))
            try:
                tokens = handle.result(timeout=float(
                    request.get("timeout_s", 300.0)))
            except TimeoutError:
                serve_metrics().request_timeouts.inc()
                raise
        prefill_resp = prefill_result["response"]
        return {
            "tokens": tokens,
            "num_tokens": len(tokens),
            "finish_reason": handle.finish_reason,
            # First token latency belongs to the prefill replica; the
            # decode-side tpot covers the migrated remainder.
            "ttft_s": prefill_resp.get("ttft_s"),
            "tpot_s": handle.tpot_s,
        }
