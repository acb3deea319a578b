"""Disaggregated serving helpers. So far the draft-model helpers of
speculative decoding (``spec.py``); the prefill/decode split and its KV
migration come with the disaggregated-serving slice."""

from ray_tpu_torch.serve.llm.disagg.spec import build_draft, draft_config_for

__all__ = ["build_draft", "draft_config_for"]
