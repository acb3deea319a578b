"""The port's observability (``ray_tpu_torch.util.metrics``,
``util.tracing``, ``observability.{serve,accounting,control}``) and the
serving engine's hooks, on the CPU, against the JAX package.

- The unit cases of the reference's ``tests/test_serve_accounting.py``
  (``RequestMeter``, ``TenantLedger``, ``slo_targets``, ``SLOTracker``) run
  once per package: for the port, ``ray_tpu.observability.accounting`` is
  swapped for ``ray_tpu_torch.observability.accounting`` in
  ``sys.modules`` while a case runs, so the reference's own assertions
  hold the port's classes.
- The metrics registry: the same calls on both packages give equal
  snapshots and ``local_summary`` views.
- Spans: the reference records SPAN events only into a connected
  worker's buffer, so the test monkeypatches
  ``ray_tpu._private.worker.global_worker_or_none`` with a stand-in that
  has that buffer; the port records into its process-local span buffer.
  The same two-hop request under ``trace_root`` gives the same tree of
  span names, attribute keys and parents (durations are not compared).
- Engine counters: the same request sequence through both packages'
  engines gives the same ledger rows (all but the time-based fields) and
  the same ``serve_*`` counter growth.
"""

import importlib.util
import os
import sys
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

PKGS = ("jax", "torch")
_CACHE = {}


def _ref_accounting_tests():
    """The reference's accounting test module, loaded under a private name
    (its Test classes are not re-collected here)."""
    if "ref_tests" not in _CACHE:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "test_serve_accounting.py")
        spec = importlib.util.spec_from_file_location(
            "_reference_serve_accounting_cases", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _CACHE["ref_tests"] = mod
    return _CACHE["ref_tests"]


_UNIT_CLASSES = ("TestRequestMeter", "TestTenantLedger", "TestSLOTargets",
                 "TestSLOTracker")
_UNIT_CASES = [
    ("TestRequestMeter", m) for m in (
        "test_block_seconds_integration", "test_preempt_resume_stays_monotone",
        "test_double_release_never_subtracts", "test_finalize_is_idempotent",
        "test_unknown_chip_phase_rejected", "test_absorb_makes_one_row",
        "test_queue_wait_and_spec_ratio")] + [
    ("TestTenantLedger", m) for m in (
        "test_overflow_folds_into_other", "test_top_sorted_by_chip_seconds",
        "test_comma_in_tenant_is_cleaned")] + [
    ("TestSLOTargets", m) for m in (
        "test_parse_lane_spec", "test_config_defaults_resolve_both_lanes")] + [
    ("TestSLOTracker", m) for m in (
        "test_good_traffic_never_fires", "test_fires_once_per_episode",
        "test_slow_window_gates_one_blip", "test_clears_and_refires",
        "test_snapshot_shape")]


def test_unit_case_list_covers_the_reference_classes():
    mod = _ref_accounting_tests()
    listed = {(c, m) for c, m in _UNIT_CASES}
    found = {(c, m) for c in _UNIT_CLASSES
             for m in dir(getattr(mod, c)) if m.startswith("test_")}
    assert listed == found


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("cls,method", _UNIT_CASES)
def test_accounting_unit_cases(pkg, cls, method, monkeypatch):
    """One case of the reference's unit tier on one package's classes."""
    mod = _ref_accounting_tests()
    if pkg == "torch":
        from ray_tpu_torch.observability import accounting as port

        monkeypatch.setitem(sys.modules, "ray_tpu.observability.accounting",
                            port)
    getattr(getattr(mod, cls)(), method)()


# ------------------------------------------------------------ the registry

def _metrics_mod(pkg):
    if pkg == "jax":
        from ray_tpu.util import metrics
    else:
        from ray_tpu_torch.util import metrics
    return metrics


def _registry_calls(M, prefix):
    """The same calls on one package's registry; returns what they
    raised, in order."""
    raised = []
    c = M.Counter(prefix + "requests", description="d",
                  tag_keys=("route", "code"))
    c.inc(tags={"route": "/a", "code": "200"})
    c.inc(2.5, tags={"route": "/a", "code": "200"})
    c.set_default_tags({"code": "500"}).inc(tags={"route": "/b"})
    g = M.Gauge(prefix + "depth")
    g.set(3.0)
    g.set(1.5)
    h = M.Histogram(prefix + "latency", boundaries=(0.1, 1.0, 0.5),
                    tag_keys=("lane",))
    for v, tid in ((0.05, "t1"), (0.7, "t2"), (3.0, None), (0.7, "t3")):
        h.observe(v, tags={"lane": "batch"}, trace_id=tid)
    h.observe(0.2, tags={"lane": "interactive"})
    alias = M.Counter(prefix + "requests", description="d",
                      tag_keys=("route", "code"))
    alias.inc(tags={"route": "/a", "code": "200"})
    for bad in (lambda: c.inc(-1.0),
                lambda: c.inc(tags={"nope": "x"}),
                lambda: c.inc(tags={"route": "a,b"}),
                lambda: M.Gauge(prefix + "requests"),
                lambda: M.Histogram(prefix + "bad", boundaries=(0.0, 1.0)),
                lambda: M.Counter("9starts_with_digit")):
        try:
            bad()
            raised.append(None)
        except (ValueError, TypeError) as e:
            raised.append(type(e).__name__)
    return raised, (c, g, h)


def _scrub(snap):
    """A snapshot without the exemplars' wall-clock stamps."""
    snap = dict(snap)
    if "exemplars" in snap:
        snap["exemplars"] = {k: {f: v for f, v in e.items() if f != "ts"}
                             for k, e in snap["exemplars"].items()}
    return snap


def test_metrics_registry_matches_reference():
    """Counters, gauges and histograms (bucketing, sum, count, the
    max-value exemplar), default tags, re-declaration aliasing and the
    refused calls: equal snapshots and local_summary views."""
    prefix = "torch_port_parity_"
    out = {}
    for pkg in PKGS:
        M = _metrics_mod(pkg)
        raised, metrics = _registry_calls(M, prefix)
        out[pkg] = (raised, [_scrub(m._snapshot()) for m in metrics],
                    M.local_summary([prefix]))
    assert out["torch"] == out["jax"]
    raised, snaps, summary = out["torch"]
    assert raised == ["ValueError"] * 6
    assert summary[prefix + "requests"]["data"] == {
        'route="/a",code="200"': 4.5, 'route="/b",code="500"': 1.0}
    assert snaps[2]["exemplars"]["batch"]["trace_id"] == "t3"
    assert any(r["name"] == prefix + "depth"
               for r in _metrics_mod("torch").snapshot_records())


def test_flush_sampler_runs_before_each_snapshot():
    from ray_tpu_torch.util import metrics as M

    g = M.Gauge("torch_port_sampled")
    seen = []

    def sample():
        seen.append(1)
        g.set(float(len(seen)))

    def broken():
        raise RuntimeError("a broken sampler must not stop a snapshot")

    M.register_flush_sampler(sample)
    M.register_flush_sampler(broken)
    M.register_flush_sampler(sample)          # registered once
    before = len(seen)
    summary = M.local_summary(["torch_port_sampled"])
    assert len(seen) == before + 1
    assert summary["torch_port_sampled"]["data"][""] == float(len(seen))


# ------------------------------------------------------------ tracing

def test_tracing_context_matches_reference():
    """TraceContext's wire form, child contexts, trace_root/span nesting
    and an error tag, record_span's ambient parenting, and the tree and
    critical path read back, in both packages."""
    from ray_tpu.util import tracing as JT
    from ray_tpu_torch.util import tracing as TT

    def run(mod, events):
        with mod.trace_root("root", attrs={"a": 1},
                            baggage={"lane": "batch"}) as tc:
            wire = tc.to_wire()
            child = mod.child_context()
            with mod.span("outer", attrs={"k": 2}):
                mod.record_span("phase", 0.0, 0.25, attrs={"p": 1})
                try:
                    with mod.span("fails"):
                        raise KeyError("x")
                except KeyError:
                    pass
        assert mod.current_trace() is None
        tree = mod.build_trace_tree(events(tc.trace_id))
        return {"wire_keys": sorted(wire),
                "baggage": wire["b"],
                "from_wire": mod.TraceContext.from_wire(wire).parent_span_id,
                "child_parent": child.parent_span_id == tc.span_id,
                "tree": _canon(tree["root"]), "orphans": tree["orphans"],
                "path": [h["name"] for h in
                         mod.critical_path(tree)["path"]]}

    with _fake_worker() as w:
        want = run(JT, lambda tid: [e for e in w._task_events
                                    if e.get("trace_id") == tid])
    got = run(TT, TT.span_events)
    assert got == want
    assert got["tree"][0] == "root" and got["orphans"] == []


def test_span_buffer_is_bounded_and_drains():
    from ray_tpu_torch.util import tracing as TT

    TT.drain_span_events()
    for i in range(3):
        TT.record_span("x", float(i), 0.0)
    assert [e["ts"] for e in TT.span_events()][-3:] == [0.0, 1.0, 2.0]
    assert all(e["state"] == "SPAN" and e["task_id"] == TT.SPAN_TASK_ID
               for e in TT.span_events())
    assert len(TT.drain_span_events()) == 3 and TT.span_events() == []
    assert TT._spans.maxlen == TT.SPAN_BUFFER_SIZE
    roots = TT.span_tree([{"task_id": TT.SPAN_TASK_ID, "name": "x", "state": "SPAN",
                           "ts": 0.0, "dur": 1.0, "attrs": {}}])
    assert roots[0]["name"] == "(orphaned-spans)"


class _FakeWorker:
    """What the reference's record_span needs of a connected worker."""

    def __init__(self):
        self._task_events = []
        self._task_events_lock = threading.Lock()

    def current_task_id(self):
        return None


class _fake_worker:
    """Context manager: the reference sees ``_FakeWorker`` as its global
    worker (the JAX package itself is not changed)."""

    def __enter__(self):
        from ray_tpu._private import worker as W

        self._mp = pytest.MonkeyPatch()
        self.w = _FakeWorker()
        self._mp.setattr(W, "global_worker_or_none", lambda: self.w)
        return self.w

    def __exit__(self, *exc):
        self._mp.undo()


def _canon(node):
    """(name, attribute keys, children) with children in name order:
    the tree's shape without times or ids."""
    return (node["name"], tuple(sorted(node["attrs"])),
            tuple(sorted((_canon(c) for c in node["children"]),
                         key=repr)))


# ------------------------------------------------------------ the engines

_GEO = dict(num_slots=4, max_seq_len=128, prefill_buckets=(16, 32),
            kv_layout="paged", kv_block_size=8, decode_block=1)


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


def _servers(pkg):
    """A prefill and a decode server of one package, built once."""
    key = ("servers", pkg)
    if key not in _CACHE:
        jc, jp, tc, tp = _model()
        if pkg == "jax":
            from ray_tpu.serve.llm.disagg import DecodeServer, PrefillServer
            kw = dict(model_config=jc, params_loader=lambda: jp)
        else:
            from ray_tpu_torch.serve.llm import DecodeServer, PrefillServer
            kw = dict(model_config=tc, params_loader=lambda: tp,
                      device="cpu")
        _CACHE[key] = (PrefillServer(engine_config=dict(_GEO),
                                     quantize="bf16", **kw),
                       DecodeServer(engine_config=dict(_GEO),
                                    quantize="bf16", **kw))
    return _CACHE[key]


@pytest.fixture(scope="module", autouse=True)
def _stop_servers():
    yield
    for pkg in PKGS:
        for s in _CACHE.pop(("servers", pkg), ()):
            s._stop.set()


def _two_hop(pkg, tracing, prompt, n):
    pre, dec = _servers(pkg)
    req = {"prompt": prompt, "max_tokens": n, "tenant": "acme"}
    with tracing.trace_root("client", attrs={"pkg": pkg}) as tc:
        res = pre.prefill(req)
        out = dec.adopt(res, req)
        short = dec({"prompt": prompt[:5], "max_tokens": 3})
    return tc.trace_id, out, short


def test_two_hop_span_tree_matches_reference():
    """One two-hop request and one short request under trace_root: the
    reference's SPAN events (through the stand-in worker) and the port's
    span buffer form the same tree: llm.disagg_prefill and
    llm.disagg_decode under the root, each with its llm.request and
    phases, kv.migrate under the decode side's llm.request, and
    llm.server_call for the short one."""
    from ray_tpu.util import tracing as JT
    from ray_tpu_torch.util import tracing as TT

    prompt = np.random.RandomState(21).randint(0, 256, 20).tolist()
    with _fake_worker() as w:
        jtid, jout, jshort = _two_hop("jax", JT, prompt, 8)
        jtree = JT.build_trace_tree([e for e in w._task_events
                                     if e.get("trace_id") == jtid])
    ttid, tout, tshort = _two_hop("torch", TT, prompt, 8)
    ttree = TT.build_trace_tree(TT.span_events(ttid))
    assert tout["tokens"] == jout["tokens"]
    assert tshort["tokens"] == jshort["tokens"]
    assert jtree["orphans"] == [] and ttree["orphans"] == []
    assert _canon(ttree["root"]) == _canon(jtree["root"])
    root = ttree["root"]
    assert root["name"] == "client" and root["attrs"]["trace_root"]
    kids = {c["name"]: c for c in root["children"]}
    assert set(kids) == {"llm.disagg_prefill", "llm.disagg_decode",
                         "llm.server_call"}
    dec_req = kids["llm.disagg_decode"]["children"][0]
    assert dec_req["name"] == "llm.request"
    assert dec_req["attrs"]["finish_reason"] == "length"
    assert "kv.migrate" in {c["name"] for c in dec_req["children"]}
    pre_req = kids["llm.disagg_prefill"]["children"][0]
    assert pre_req["attrs"]["finish_reason"] == "prefill"


def _rows(pkg):
    if pkg == "jax":
        from ray_tpu.observability import accounting
    else:
        from ray_tpu_torch.observability import accounting
    return accounting


_ROW_KEYS = ("tenant", "model", "lane", "tokens_out",
             "prefill_tokens_computed", "prefill_tokens_avoided",
             "spec_proposed", "spec_accepted", "migrations",
             "finish_reason", "finished")


def _counters(pkg):
    """{(counter name, label string): value} of every serve_* counter but
    the time-valued ones (tenant chip and block seconds), and the count of
    every serve_* histogram."""
    out = {}
    for name, rec in _metrics_mod(pkg).local_summary(["serve_"]).items():
        for label, cell in rec["data"].items():
            if rec["type"] == "counter" and "_seconds_" not in name:
                out[(name, label)] = cell
            elif rec["type"] == "histogram":
                out[(name + ":count", label)] = cell["count"]
    return out


# (step to submit at, prompt seed, prompt length, max_tokens, lane, tenant)
_SCHEDULE = [(0, 40, 20, 6, "interactive", "acme"),
             (0, 41, 26, 5, "batch", "bob"),
             (1, 40, 20, 4, "interactive", "acme"),     # a pool prefix hit
             (3, 42, 60, 4, "interactive", "carol")]    # chunked


def _drive(pkg):
    """The schedule through one package's engines (a paged one with a
    prefix cache, a speculative one, and a prefill -> decode hand-off),
    stepped on this thread; returns the rows folded while it ran, the
    serve_* counter growth, and the tokens."""
    jc, jp, tc, tp = _model()
    M, params, cfg = ((JE, jp, jc) if pkg == "jax" else (E, tp, tc))
    kw = {} if pkg == "jax" else {"device": "cpu"}

    def engine(**extra):
        geo = {**_GEO, **{k: v for k, v in extra.items()
                          if not k.startswith("draft")}}
        draft = ({"draft_params": params, "draft_config": cfg}
                 if extra.get("draft") else {})
        return M.LLMEngine(params, cfg, M.EngineConfig(**geo), **draft,
                           **kw)

    acct = _rows(pkg)
    rows = []
    acct.register_row_hook(rows.append)
    before = _counters(pkg)
    try:
        eng = engine()
        handles = []
        for step in range(200):
            for at, seed, n, m, lane, tenant in _SCHEDULE:
                if at == step:
                    p = np.random.RandomState(seed).randint(0, 256, n)
                    handles.append(eng.submit(M.Request(
                        prompt=p.tolist(), max_tokens=m, slo=lane,
                        tenant=tenant, chunked_prefill=n > 32)))
            eng.step()
            if step > _SCHEDULE[-1][0] and not eng.has_work():
                break
        queued = eng.submit(M.Request(prompt=[1, 2, 3], max_tokens=2,
                                      tenant="gone"))
        eng.cancel(queued)
        spec = engine(spec_k=3, draft=True)
        p = np.random.RandomState(43).randint(0, 256, 14).tolist()
        hs = spec.submit(M.Request(prompt=p, max_tokens=8, tenant="dan"))
        spec.drain()
        pre, dec = engine(), engine()
        h1 = pre.submit(M.Request(prompt=p, max_tokens=7, prefill_only=True,
                                  tenant="erin"))
        pre.drain()
        h2 = dec.submit_adopted(M.Request(prompt=p, max_tokens=7,
                                          tenant="erin"), h1.kv_state,
                                meter_snapshot=h1.meter.snapshot())
        dec.drain()
    finally:
        acct.unregister_row_hook(rows.append)
    after = _counters(pkg)
    growth = {k: v - before.get(k, 0.0) for k, v in after.items()
              if v != before.get(k, 0.0)}
    blocks_held = [h.meter.blocks_held for h in handles + [hs, h2]]
    return {"rows": [{k: r[k] for k in _ROW_KEYS} for r in rows],
            "block_seconds": [r["block_seconds"] > 0 for r in rows],
            "growth": growth, "blocks_held": blocks_held,
            "tokens": [h.tokens for h in handles + [hs, h2]],
            "chunks": eng.stats().get("chunked_prefill")}


def test_engine_rows_and_counters_match_reference():
    """The same requests (tenants, both lanes, a prefix hit, a chunked
    prompt, a cancel in the queue, a speculative request, a migrated
    request with its prefill-side meter absorbed) through both packages'
    engines: equal ledger rows in order (but for times), equal serve_*
    counter growth, every meter's blocks released. The migrated request
    folds one row, on the decode side."""
    want, got = _drive("jax"), _drive("torch")
    assert got["tokens"] == want["tokens"]
    assert got["rows"] == want["rows"]
    assert got["block_seconds"] == want["block_seconds"]
    assert got["growth"] == want["growth"]
    assert got["blocks_held"] == [0] * len(got["blocks_held"])
    rows = got["rows"]
    assert [r["tenant"] for r in rows].count("erin") == 1
    erin = next(r for r in rows if r["tenant"] == "erin")
    assert erin["migrations"] == 1 and erin["prefill_tokens_computed"] == 14
    assert any(r["finish_reason"] == "cancelled" for r in rows)
    assert any(r["prefill_tokens_avoided"] > 0 for r in rows)
    assert next(r for r in rows if r["tenant"] == "dan")["spec_proposed"] > 0
    growth = got["growth"]
    assert growth[("serve_kv_migrated_blocks_total", "")] > 0
    assert growth[("serve_prefix_cache_hits_total", "")] >= 1


def test_token_reconciler_across_a_two_hop_request():
    """The reconciler holds over one engine. Across a prefill -> decode
    hand-off in one process, serve_tokens_total counts the migrated first
    token on both hops (the prefill finish and the decode finish each add
    their handle's tokens) while only the decode side folds a row: the
    counter runs one token per two-hop request ahead of the meters, in
    the reference and in the port alike."""
    p = np.random.RandomState(44).randint(0, 256, 14).tolist()
    for pkg in PKGS:
        jc, jp, tc, tp = _model()
        M, params, cfg = ((JE, jp, jc) if pkg == "jax" else (E, tp, tc))
        kw = {} if pkg == "jax" else {"device": "cpu"}
        pre = M.LLMEngine(params, cfg, M.EngineConfig(**_GEO), **kw)
        dec = M.LLMEngine(params, cfg, M.EngineConfig(**_GEO), **kw)
        acct = _rows(pkg)
        with acct.TokenReconciler() as one:
            h = dec.submit(M.Request(prompt=p, max_tokens=5))
            dec.drain()
        assert one.holds(), (pkg, one.detail())
        with acct.TokenReconciler() as two:
            h1 = pre.submit(M.Request(prompt=p, max_tokens=5,
                                      prefill_only=True))
            pre.drain()
            h2 = dec.submit_adopted(M.Request(prompt=p, max_tokens=5),
                                    h1.kv_state,
                                    meter_snapshot=h1.meter.snapshot())
            dec.drain()
        assert h2.tokens == h.tokens
        assert two.meter_sum == 5 and two.counter_delta == 6, (
            pkg, two.detail())


def test_preemption_records_what_the_reference_records():
    """A preemption makes the reference's record_decision call, which
    passes its reading as a bare float and a keyword record_decision does
    not take, so it raises and the engine drops the decision. The port
    makes the same call: in both packages ctrl_decisions_total{llm_engine,
    preempt} does not move, and the port records no ctrl:llm_engine
    span; the preemption itself and the tokens are the reference's."""
    from ray_tpu_torch.util import tracing as TT

    p = np.random.RandomState(45).randint(0, 256, 14).tolist()
    label = 'controller="llm_engine",action="preempt"'
    out = {}
    for pkg in PKGS:
        jc, jp, tc, tp = _model()
        M, params, cfg = ((JE, jp, jc) if pkg == "jax" else (E, tp, tc))
        kw = {} if pkg == "jax" else {"device": "cpu"}
        eng = M.LLMEngine(params, cfg, M.EngineConfig(
            **{**_GEO, "num_slots": 1, "preempt_hold_s": 0.0,
               "preempt_cooldown_s": 0.0}), **kw)

        def decisions():
            rec = _metrics_mod(pkg).local_summary(
                ["ctrl_decisions_total"]).get("ctrl_decisions_total")
            return rec["data"].get(label, 0.0) if rec else 0.0

        d0 = decisions()
        TT.drain_span_events()
        b = eng.submit(M.Request(prompt=p, max_tokens=12, slo="batch"))
        eng.step()
        i = eng.submit(M.Request(prompt=p, max_tokens=2))
        eng.drain()
        out[pkg] = (eng.stats()["preempted"], decisions() - d0, b.tokens,
                    i.tokens)
    assert out["torch"][0] == out["jax"][0] == 1
    assert out["torch"][2:] == out["jax"][2:]
    assert out["torch"][1] == out["jax"][1] == 0.0
    assert not [e for e in TT.span_events()
                if e["name"] == "ctrl:llm_engine"]


def test_accounting_knob_off_attaches_no_meter(monkeypatch):
    """serve_accounting_instrumentation off (latched at engine init): no
    meter, no row; the serve metrics still count the request."""
    from ray_tpu_torch.observability import accounting

    _, _, tc, tp = _model()
    monkeypatch.setenv("RAY_TPU_serve_accounting_instrumentation", "0")
    eng = E.LLMEngine(tp, tc, E.EngineConfig(
        num_slots=1, max_seq_len=32, prefill_buckets=(8,)), device="cpu")
    monkeypatch.delenv("RAY_TPU_serve_accounting_instrumentation")
    rows = []
    accounting.register_row_hook(rows.append)
    try:
        with accounting.TokenReconciler() as rec:
            h = eng.submit(E.Request(prompt=[1, 2, 3], max_tokens=2))
            eng.drain()
    finally:
        accounting.unregister_row_hook(rows.append)
    assert h.finish_reason == "length" and h.meter is None and rows == []
    assert rec.counter_delta == 2 and rec.meter_sum == 0


def test_server_counts_timeouts_and_passes_tenant():
    """LLMServer.__call__ submits inside llm.server_call with the request's
    tenant, and a wait past timeout_s is counted and raised."""
    from ray_tpu_torch.observability import accounting
    from ray_tpu_torch.observability.serve import serve_metrics
    from ray_tpu_torch.serve.llm import LLMServer
    from ray_tpu_torch.util.metrics import local_summary

    _, _, tc, tp = _model()
    server = LLMServer(model_config=tc, engine_config=dict(_GEO),
                       params_loader=lambda: tp, quantize="bf16",
                       device="cpu")
    rows = []
    accounting.register_row_hook(rows.append)
    try:
        out = server({"prompt": [5, 6, 7], "max_tokens": 3,
                      "tenant": "zed"})
        assert out["num_tokens"] == 3
        serve_metrics()
        name = "serve_request_timeouts_total"
        before = local_summary([name]).get(name, {}).get("data", {})
        with pytest.raises(TimeoutError):
            server({"prompt": [5, 6, 7], "max_tokens": 60,
                    "timeout_s": 0.0})
        after = local_summary([name])[name]["data"]
        assert after[""] - before.get("", 0.0) == 1.0
    finally:
        server.shutdown()
        accounting.unregister_row_hook(rows.append)
    assert rows[0]["tenant"] == "zed"
