"""PrefillServer — the prefill half of a disaggregated LLM tier: the
port's copy of ``ray_tpu/serve/llm/disagg/prefill.py``.

An ``LLMServer`` whose public method is ``prefill``: run the request
through admission (chunked for prompts past the largest bucket, so one
long prefill never monopolizes the engine for a whole step) up to its
FIRST sampled token, then export the sequence's paged KV blocks as a
:class:`~ray_tpu_torch.serve.llm.kv_cache.KVState` (CPU tensors) and
free the slot. The returned dict is what a :class:`DecodeServer`'s
``adopt`` takes; in the reference the router forwards it between
replicas through the object store, which waits for the port's runtime,
so here the caller hands it over in-process.

A request that already terminates at its first token (stop / eos /
``max_tokens == 1`` / sequence limit) comes back ``done`` with the
finished response, and the decode hop is skipped.
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.serve.llm.deployment import LLMServer

__all__ = ["PrefillServer"]


class PrefillServer(LLMServer):
    """Deployment callable for the prefill pool.

    The engine config should lean prefill-shaped: few slots (each
    admission occupies a slot only for its prefill), a deep block pool,
    and ``prefix_cache=True`` so shared prompt prefixes amortize across
    requests — and so chunked long-prompt prefill works at all (chunks
    hand off through the prefix cache).
    """

    def prefill(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Run prefill + first token for ``request`` (same dict schema
        as ``LLMServer.__call__``) and return::

            {"done": bool,          # True: response is final
             "response": {...},     # __call__-shaped result dict
             "kv_state": KVState | None,
             "request": {...}}      # echo for the decode hop

        Long prompts are admitted in bucket-sized chunks automatically
        (``chunked_prefill``), interleaving with other admissions.
        """
        from ray_tpu_torch.observability import serve_metrics
        from ray_tpu_torch.serve.llm.disagg.transfer import KVExporter
        from ray_tpu_torch.serve.llm.engine import Request
        from ray_tpu_torch.util.tracing import span

        prompt = list(request["prompt"])
        req = Request(
            prompt=prompt,
            max_tokens=int(request.get("max_tokens", 64)),
            temperature=float(request.get("temperature", 0.0)),
            stop=tuple(request.get("stop", ())),
            slo=str(request.get("slo", "interactive")),
            prefill_only=True,
            chunked_prefill=True,
            tenant=str(request.get("tenant", "default")))
        with span("llm.disagg_prefill",
                  attrs={"prompt_len": len(prompt)}):
            try:
                handle = KVExporter(self._engine).run(
                    req, timeout_s=float(request.get("timeout_s", 300.0)))
            except TimeoutError:
                serve_metrics().request_timeouts.inc()
                raise
        return {
            "done": handle.kv_state is None,
            "response": {
                "tokens": handle.tokens,
                "num_tokens": len(handle.tokens),
                "finish_reason": handle.finish_reason,
                "ttft_s": handle.ttft_s,
                "tpot_s": handle.tpot_s,
            },
            "kv_state": handle.kv_state,
            # Cost meter snapshot rides next to the KVState (NOT inside
            # it — KVState is a strict device-payload schema): the
            # decode tier's meter absorbs it so prefill chip-seconds
            # land on the migrated request's single ledger row.
            "meter": (handle.meter.snapshot()
                      if handle.meter is not None else None),
            "request": dict(request),
        }
