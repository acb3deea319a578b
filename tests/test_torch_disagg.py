"""The port's disaggregated serving tier (``Request.prefill_only``,
``LLMEngine.submit_adopted``, ``export_prefix``/``import_prefix``,
``call_on_scheduler``, ``PrefillServer``/``DecodeServer``) on
``device="cpu"``, against the JAX package.

The reference's ``test_serve_llm_disagg.py`` geometry: ``tiny``, 4 slots,
sequence 128, buckets 16/32, block 8, here in f32 on both sides (greedy
tokens of the two frameworks are identical there). Every scenario runs the
same request sequence through the JAX package's engines and the port's
and returns what it saw; the two must be equal (KV payloads to 1e-4, the
f32 summation-order bound of ``test_torch_paged.py``). Engines are cached
per package and per geometry, so both packages' engines always carry the
same history; each scenario uses prompts of its own.
"""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import llama as J  # noqa: E402
from ray_tpu.serve.llm import engine as JE  # noqa: E402
from ray_tpu_torch.models import llama as T  # noqa: E402
from ray_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from ray_tpu_torch.serve.llm import engine as E  # noqa: E402

F32_TOL = 1e-4
PKGS = ("jax", "torch")
_GEO = dict(num_slots=4, max_seq_len=128, prefill_buckets=(16, 32),
            kv_layout="paged", kv_block_size=8, decode_block=1)
# Engines by role: geometry overrides and whether they carry a draft.
_ROLES = {
    "prefill": ({}, False),
    "decode": ({}, False),
    # Barely one sequence's blocks at a time (the reference test's).
    "tight": (dict(num_slots=2, num_kv_blocks=6, prefix_cache=False),
              False),
    # A self-draft: speculation accepts nearly everything.
    "spec": (dict(spec_k=3), True),
    # Always promotes (recompute priced far above the copy).
    "recv": (dict(kv_prefill_cost_per_token_ms=50.0), False),
}
_CACHE = {}


def _np_tree(tree):
    def leaf(a):
        if jnp.issubdtype(a.dtype, jnp.floating):
            return np.asarray(a.astype(jnp.float32))
        return np.asarray(a)
    return jax.tree_util.tree_map(leaf, tree)


def _model():
    if "model" not in _CACHE:
        jc = J.LlamaConfig.tiny(dtype=jnp.float32)
        jp = J.init_params(jc, jax.random.key(0))
        tc = T.LlamaConfig.tiny(dtype=torch.float32)
        _CACHE["model"] = (jc, jp, tc, params_from_numpy(_np_tree(jp), tc,
                                                          "cpu"))
    return _CACHE["model"]


def _mod(pkg):
    return JE if pkg == "jax" else E


def _engine(pkg, role, **extra):
    """The cached engine of ``role`` for one package (``extra``: more
    geometry, part of the cache key)."""
    key = (pkg, role, tuple(sorted(extra.items())))
    if key not in _CACHE:
        jc, jp, tc, tp = _model()
        overrides, draft = _ROLES[role]
        geo = {**_GEO, **overrides, **extra}
        if pkg == "jax":
            kw = dict(draft_params=jp, draft_config=jc) if draft else {}
            _CACHE[key] = JE.LLMEngine(jp, jc, JE.EngineConfig(**geo), **kw)
        else:
            kw = dict(draft_params=tp, draft_config=tc) if draft else {}
            _CACHE[key] = E.LLMEngine(tp, tc, E.EngineConfig(**geo),
                                      device="cpu", **kw)
    return _CACHE[key]


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 256, n).tolist()


def _f32(blocks):
    if isinstance(blocks, torch.Tensor):
        return blocks.float().numpy()
    return np.asarray(blocks, np.float32)


def _prefill(pkg, prompt, n, **kw):
    """prefill_only on the package's prefill engine; the finished handle."""
    eng = _engine(pkg, "prefill")
    h = eng.submit(_mod(pkg).Request(prompt=list(prompt), max_tokens=n,
                                     prefill_only=True, **kw))
    eng.drain()
    return h


def _mono(pkg, prompt, n):
    """The same request served whole on the decode engine."""
    eng = _engine(pkg, "decode")
    h = eng.submit(_mod(pkg).Request(prompt=list(prompt), max_tokens=n))
    eng.drain()
    return h.tokens


def _state(st):
    return {"prompt": list(st.prompt), "tokens": list(st.tokens),
            "next_tok": int(st.next_tok), "pos": int(st.pos),
            "block_size": st.block_size, "n_blocks": st.n_blocks,
            "payload_bytes": st.payload_bytes,
            "shape": tuple(st.k_blocks.shape)}


def _both(scenario):
    """Run ``scenario(pkg)`` for the JAX package, then the port; compare
    everything it returned (arrays under the key "kv" to F32_TOL, the
    rest exactly) and return the port's result."""
    want, got = scenario("jax"), scenario("torch")
    for k in want:
        if k == "kv":
            for a, b in zip(got[k], want[k]):
                np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL)
        else:
            assert got[k] == want[k], (k, got[k], want[k])
    return got


def _migration(eng):
    return dict(eng.stats()["migration"])


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


# ------------------------------------------------------------- scenarios

_P_ROUND = _prompt(1, 14)


def test_export_adopt_round_trip_matches_reference():
    """prefill_only on one engine, submit_adopted on another: the first
    token crosses inside the KVState, the stream is the monolithic one,
    and the checkpoint, its blocks and the migration counters equal the
    reference's."""
    def scenario(pkg):
        M = _mod(pkg)
        h = _prefill(pkg, _P_ROUND, 12)
        st = h.kv_state
        st.validate()
        de = _engine(pkg, "decode")
        m0 = _migration(de)
        h2 = de.submit_adopted(M.Request(prompt=_P_ROUND, max_tokens=12), st)
        de.drain()
        return {"finish": h.finish_reason, "first": list(h.tokens),
                "state": _state(st), "kv": [_f32(st.k_blocks),
                                            _f32(st.v_blocks)],
                "tokens": list(h2.tokens), "reason": h2.finish_reason,
                "mono": _mono(pkg, _P_ROUND, 12),
                "migration": _delta(_migration(de), m0),
                "prefill_active": _engine(pkg, "prefill").stats()[
                    "active_slots"],
                "adopted_prefilled": h2.prefilled_tokens}

    got = _both(scenario)
    assert got["finish"] == "prefill" and got["first"] == got["tokens"][:1]
    assert got["tokens"] == got["mono"] and got["reason"] == "length"
    assert got["state"]["payload_bytes"] == 2 * got["kv"][0].nbytes
    assert got["migration"] == {"blocks": got["state"]["n_blocks"],
                                "bytes": got["state"]["payload_bytes"]}
    assert got["prefill_active"] == 0 and got["adopted_prefilled"] == 0


def test_adopt_registers_prefix_for_lookalikes():
    """Adoption registers the migrated prompt in the decode engine's
    prefix cache: a lookalike prompt hits the migrated blocks and still
    decodes to the monolithic stream."""
    p = _prompt(2, 27)

    def scenario(pkg):
        M = _mod(pkg)
        h = _prefill(pkg, p, 10)
        de = _engine(pkg, "decode")
        de.submit_adopted(M.Request(prompt=p, max_tokens=10), h.kv_state)
        de.drain()
        before = de.stats()["prefix_cache"]
        h3 = de.submit(M.Request(prompt=list(p), max_tokens=10))
        de.drain()
        after = de.stats()["prefix_cache"]
        return {"tokens": list(h3.tokens),
                "hits": after["hits"] - before["hits"],
                "hit_tokens": after["hit_tokens"] - before["hit_tokens"],
                "prefilled": h3.prefilled_tokens}

    got = _both(scenario)
    assert got["hits"] == 1 and got["hit_tokens"] == 24
    assert got["prefilled"] == 3


def test_adopt_all_or_nothing_under_exhaustion():
    """An adoption the pool cannot cover allocates nothing and queues
    (no crash); once the blocker finishes it lands and decodes to the
    monolithic stream, and the pool is whole again."""
    p = _prompt(3, 14)

    def scenario(pkg):
        M = _mod(pkg)
        h = _prefill(pkg, p, 12)
        de = _engine(pkg, "tight")
        free0 = de.stats()["kv"]["free_blocks"]
        blocker = de.submit(M.Request(prompt=p, max_tokens=30))
        de.step()
        used = de.stats()["kv"]["used_blocks"]
        h2 = de.submit_adopted(M.Request(prompt=p, max_tokens=12),
                               h.kv_state)
        de.step()
        queued = (h2.done(), de.stats()["kv"]["used_blocks"],
                  de.stats()["queued"])
        de.drain()
        return {"queued": queued, "used": used,
                "tokens": list(h2.tokens), "blocker": list(blocker.tokens),
                "free_after": de.stats()["kv"]["free_blocks"] - free0}

    got = _both(scenario)
    assert got["queued"] == (False, got["used"], 1)
    assert got["free_after"] == 0


def test_cancel_queued_adopted_request():
    """A queued adopted request cancels at once as "cancelled", touching
    no block; the engine drains back to an empty pool."""
    p = _prompt(4, 14)

    def scenario(pkg):
        M = _mod(pkg)
        h = _prefill(pkg, p, 12)
        de = _engine(pkg, "tight")
        free0 = de.stats()["kv"]["free_blocks"]
        blocker = de.submit(M.Request(prompt=p, max_tokens=20))
        de.step()
        used = de.stats()["kv"]["used_blocks"]
        h2 = de.submit_adopted(M.Request(prompt=p, max_tokens=12),
                               h.kv_state)
        cancelled = h2.cancel()
        after_cancel = (h2.done(), h2.finish_reason,
                        de.stats()["kv"]["used_blocks"],
                        de.stats()["queued"])
        de.drain()
        return {"cancelled": cancelled, "after": after_cancel,
                "used": used, "again": h2.cancel(),
                "blocker": list(blocker.tokens),
                "migration_free": de.stats()["kv"]["free_blocks"] - free0}

    got = _both(scenario)
    assert got["cancelled"] and not got["again"]
    assert got["after"] == (True, "cancelled", got["used"], 0)
    assert got["migration_free"] == 0


def test_speculative_decode_of_an_adopted_checkpoint():
    """Migration composes with speculation: the decode engine re-seeds its
    draft's cache from the adopted prompt and the tokens emitted so far,
    and the stream is the monolithic one."""
    p = _prompt(5, 14)

    def scenario(pkg):
        M = _mod(pkg)
        h = _prefill(pkg, p, 12)
        se = _engine(pkg, "spec")
        r0 = se.stats()["spec"]["rounds"]
        h2 = se.submit_adopted(M.Request(prompt=p, max_tokens=12),
                               h.kv_state)
        se.drain()
        return {"tokens": list(h2.tokens), "mono": _mono(pkg, p, 12),
                "rounds": se.stats()["spec"]["rounds"] > r0}

    got = _both(scenario)
    assert got["tokens"] == got["mono"] and got["rounds"]


def test_prefill_only_ending_at_its_first_token():
    """A prefill_only request that ends at its first token exports
    nothing: a stop token (nothing emitted), eos (emitted) and
    max_tokens 1 finish with their reasons and kv_state None, and the
    slot's blocks are freed; an eos engine is built from the stream's own
    first token."""
    p = _prompt(6, 20)

    def scenario(pkg):
        M = _mod(pkg)
        first = _prefill(pkg, p, 8).tokens[0]
        out = {}
        for case, kw in (("stop", dict(stop=(first,))),
                         ("length", {})):
            n = 1 if case == "length" else 8
            h = _prefill(pkg, p, n, **kw)
            out[case] = (h.finish_reason, list(h.tokens),
                         h.kv_state is None)
        eng = _engine(pkg, "prefill", eos_id=int(first))
        h = eng.submit(M.Request(prompt=p, max_tokens=8, prefill_only=True))
        eng.drain()
        out["eos"] = (h.finish_reason, list(h.tokens), h.kv_state is None)
        out["active"] = eng.stats()["active_slots"]
        out["first"] = first
        return out

    got = _both(scenario)
    first = got["first"]
    assert got["stop"] == ("stop", [], True)
    assert got["length"] == ("length", [first], True)
    assert got["eos"] == ("eos", [first], True) and got["active"] == 0


def test_submit_adopted_validation_matches_reference():
    """The checkpoint checks raise as the reference's: block size, prompt,
    max_tokens already reached, a non-KVState, and a dense engine."""
    p = _prompt(7, 12)

    def scenario(pkg):
        M = _mod(pkg)
        st = _prefill(pkg, p, 6).kv_state
        de = _engine(pkg, "decode")
        cases = {
            "block": dataclasses.replace(st, block_size=4),
            "prompt": st, "max_tokens": st, "type": None}
        out = {}
        for case, state in cases.items():
            req = M.Request(prompt=p if case != "prompt" else p[:-1],
                            max_tokens=1 if case == "max_tokens" else 6)
            try:
                de.submit_adopted(req, state)
                out[case] = None
            except (ValueError, TypeError) as e:
                out[case] = type(e).__name__
        return out

    got = _both(scenario)
    assert got == {"block": "ValueError", "prompt": "ValueError",
                   "max_tokens": "ValueError", "type": "TypeError"}
    with pytest.raises(ValueError, match="paged"):
        dense = E.LLMEngine(_model()[3], _model()[2], E.EngineConfig(
            max_seq_len=128, prefill_buckets=(16, 32)), device="cpu")
        dense.submit(E.Request(prompt=p, max_tokens=2, prefill_only=True))


def test_peer_prefix_pull_promotes_in_both_packages():
    """export_prefix on a donor that served a prompt, import_prefix on a
    receiver that never saw it: the receiver's admission promotes every
    exported link from its host tier, prefills only the suffix, and
    decodes what the donor decodes on a pool hit of the same depth."""
    sys_p = _prompt(8, 24)
    prompt = sys_p + _prompt(9, 6)

    def scenario(pkg):
        M = _mod(pkg)
        donor = _engine(pkg, "decode")
        first = _mono(pkg, prompt, 8)
        again = _mono(pkg, prompt, 8)
        links = donor.export_prefix(prompt)
        recv = _engine(pkg, "recv")
        t0 = recv.stats()["kv_tiers"]
        n_in = recv.import_prefix(links)
        h = recv.submit(M.Request(prompt=prompt, max_tokens=8))
        recv.drain()
        t1 = recv.stats()["kv_tiers"]
        return {"links": [(len(x.tokens), x.n_blocks) for x in links],
                "kv": [np.concatenate([_f32(x.k_blocks) for x in links], 1)],
                "imported": n_in, "tokens": list(h.tokens),
                "first": first, "again": again,
                "promoted": t1["promoted_blocks"] - t0["promoted_blocks"],
                "prefilled": h.prefilled_tokens,
                "heads": len(donor.prefix_index_heads()) > 0}

    got = _both(scenario)
    assert got["links"] == [(8, 1), (16, 1), (24, 1)]
    assert got["imported"] == 3 and got["promoted"] == 3
    assert got["prefilled"] == len(prompt) - 24
    assert got["tokens"] == got["again"] == got["first"]
    assert got["heads"]


def test_prefix_index_heads_match_reference():
    """The (stable hash, depth) heads a replica would publish: pool
    entries hottest first, then tier residents, deduplicated and capped."""
    def scenario(pkg):
        eng = _engine(pkg, "recv")
        for seed in (12, 13):
            h = eng.submit(_mod(pkg).Request(prompt=_prompt(seed, 20),
                                             max_tokens=2))
            eng.drain()
        return {"heads": [tuple(map(int, h))
                          for h in eng.prefix_index_heads()],
                "capped": len(eng.prefix_index_heads(max_heads=2))}

    got = _both(scenario)
    assert got["heads"] and got["capped"] == 2


def test_prefill_and_decode_servers_match_reference():
    """PrefillServer.prefill -> DecodeServer.adopt, each an LLMServer with
    its scheduler thread, against the same hand-off through the reference's
    servers: equal responses (TTFT from the prefill side), the short-prompt
    `done` path, and a peer pull through LLMServer.export_prefix (which
    hops to the scheduler thread) and import_prefix."""
    from ray_tpu.serve.llm.disagg import (DecodeServer as JDecode,
                                          PrefillServer as JPrefill)
    from ray_tpu_torch.serve.llm import DecodeServer, PrefillServer

    jc, jp, tc, tp = _model()
    p = _prompt(10, 30)
    servers = {
        "jax": (JPrefill(model_config=jc, engine_config=dict(_GEO),
                         params_loader=lambda: jp, quantize="bf16"),
                JDecode(model_config=jc, engine_config=dict(_GEO),
                        params_loader=lambda: jp, quantize="bf16")),
        "torch": (PrefillServer(model_config=tc, engine_config=dict(_GEO),
                                params_loader=lambda: tp, quantize="bf16",
                                device="cpu"),
                  DecodeServer(model_config=tc, engine_config=dict(_GEO),
                               params_loader=lambda: tp, quantize="bf16",
                               device="cpu"))}

    def scenario(pkg):
        pre, dec = servers[pkg]
        req = {"prompt": p, "max_tokens": 10, "tenant": "acme"}
        res = pre.prefill(req)
        out = dec.adopt(res, req)
        one = pre.prefill({"prompt": p, "max_tokens": 1})
        short = dec.adopt(one, {"prompt": p, "max_tokens": 1})
        links = pre.export_prefix(p)
        return {"done": res["done"], "first": res["response"]["tokens"],
                "state": _state(res["kv_state"]),
                "meter_tenant": res["meter"]["tenant"],
                "tokens": out["tokens"], "reason": out["finish_reason"],
                "ttft_from_prefill": out["ttft_s"] ==
                res["response"]["ttft_s"],
                "short": (one["done"], short["tokens"],
                          short["finish_reason"]),
                "pulled": dec.import_prefix(links),
                "plain": dec({"prompt": p, "max_tokens": 10})["tokens"]}

    try:
        got = _both(scenario)
    finally:
        for pair in servers.values():
            for s in pair:
                s._stop.set()
        servers["torch"][0].shutdown()
        servers["torch"][1].shutdown()
    assert not got["done"] and got["first"] == got["tokens"][:1]
    assert got["tokens"] == got["plain"] and got["reason"] == "length"
    assert got["ttft_from_prefill"] and got["meter_tenant"] == "acme"
    assert got["short"] == (True, got["first"], "length")
    assert got["pulled"] == 3


def test_call_on_scheduler_relays_errors_and_times_out():
    """call_on_scheduler runs its function on the scheduler thread and
    returns its value or raises what it raised; with no thread stepping
    the engine it times out, as the reference's does."""
    from ray_tpu_torch.serve.llm import LLMServer

    for pkg in PKGS:
        with pytest.raises(TimeoutError, match="scheduler"):
            _engine(pkg, "recv").call_on_scheduler(lambda: 1, timeout_s=0.05)
    _, _, tc, tp = _model()
    server = LLMServer(model_config=tc, engine_config=dict(_GEO),
                       params_loader=lambda: tp, quantize="bf16",
                       device="cpu")
    try:
        eng = server._engine
        assert eng.call_on_scheduler(threading.current_thread) \
            is server._thread

        def boom():
            raise KeyError("from the scheduler")

        with pytest.raises(KeyError, match="from the scheduler"):
            eng.call_on_scheduler(boom, timeout_s=10.0)
        server.check_health()
        assert eng.call_on_scheduler(lambda: 7) == 7
    finally:
        server.shutdown()


def test_migration_metrics_match_reference():
    """The serve_kv_migrated_* counters grow on the importing side only,
    by the same amounts in both packages (one process-wide registry per
    package)."""
    from ray_tpu.util import metrics as JM
    from ray_tpu_torch.util import metrics as TM

    names = ["serve_kv_migrated_blocks_total",
             "serve_kv_migrated_bytes_total"]
    p = _prompt(11, 21)

    def read(summary):
        out = {}
        for n in names:
            rec = summary(names).get(n)
            out[n] = sum(rec["data"].values()) if rec else 0.0
        return out

    def scenario(pkg):
        M = _mod(pkg)
        summary = (JM if pkg == "jax" else TM).local_summary
        before = read(summary)
        h = _prefill(pkg, p, 6)
        mid = read(summary)
        de = _engine(pkg, "decode")
        de.submit_adopted(M.Request(prompt=p, max_tokens=6), h.kv_state)
        de.drain()
        after = read(summary)
        return {"export_side": {n: mid[n] - before[n] for n in names},
                "import_side": {n: after[n] - mid[n] for n in names},
                "state": _state(h.kv_state)}

    got = _both(scenario)
    assert got["export_side"] == {n: 0.0 for n in names}
    assert got["import_side"] == {
        names[0]: float(got["state"]["n_blocks"]),
        names[1]: float(got["state"]["payload_bytes"])}


def test_quantize_int8_flag_is_a_synonym_for_int8():
    """LLMServer(quantize_int8=True), the reference's legacy spelling,
    builds the same int8 weights as quantize="int8"; quantize wins when
    both are given, as in the reference."""
    from ray_tpu_torch.serve.llm import LLMServer

    _, _, tc, tp = _model()
    geo = dict(num_slots=1, max_seq_len=64, prefill_buckets=(16,))
    servers = [LLMServer(model_config=tc, engine_config=geo,
                         params_loader=lambda: tp, device="cpu", **kw)
               for kw in ({"quantize": "int8"}, {"quantize_int8": True},
                          {"quantize": "bf16", "quantize_int8": True})]
    try:
        a, b, c = (s._engine.params for s in servers)
        assert [s.quantize for s in servers] == ["int8", "int8", "bf16"]
        leaves_a = torch.utils._pytree.tree_leaves(a)
        leaves_b = torch.utils._pytree.tree_leaves(b)
        assert len(leaves_a) == len(leaves_b)
        assert all(x.dtype == y.dtype and torch.equal(x, y)
                   for x, y in zip(leaves_a, leaves_b))
        assert any(x.dtype == torch.int8 for x in leaves_a)
        assert not any(x.dtype == torch.int8
                       for x in torch.utils._pytree.tree_leaves(c))
    finally:
        for s in servers:
            s.shutdown()
