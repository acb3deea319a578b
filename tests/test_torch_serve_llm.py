"""The port's LLM serving on Serve (``build_llm_app``,
``build_routed_llm_app``, ``build_disagg_llm_app``, the ``LLMRouter``
with the cluster prefix index and the peer pull, the object-store KV
tier) on the CPU, against the JAX package.

Every replica serves ``LlamaConfig.tiny()`` in f32 with ``device="cpu"``
bound with its arguments; its weights are the JAX package's (``init_params``
at key 0), shipped as a numpy tree inside a ``params_loader`` closure and
converted in the replica (``models/convert.py::params_from_numpy``). Greedy
tokens equal the JAX package's ``generate`` exactly. The routing policy is
held against the reference's on the same inputs (the cases of
``tests/test_serve_llm.py`` and ``tests/test_kv_tiering.py``), and the
span tree, the accounting ring and the router's metric tags are read back
through the GCS. One cluster for the module; every ``get`` has a timeout.
"""

import gc
import random
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu.models import llama as J  # noqa: E402
from ray_tpu_torch import serve  # noqa: E402
from ray_tpu_torch.models import llama as T  # noqa: E402

_CACHE = {}
DENSE = {"num_slots": 2, "max_seq_len": 160, "prefill_buckets": (16, 128)}
PAGED = {"num_slots": 4, "max_seq_len": 128, "prefill_buckets": (16, 32),
         "kv_layout": "paged", "kv_block_size": 8, "prefix_cache": True}
BS = PAGED["kv_block_size"]
CACHE_WEIGHT = 0.01          # affinity breaks ties only: a busy holder loses


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(
        num_cpus=8, num_gpus=0, object_store_memory=256 * 1024 * 1024,
        _system_config={"serve_prefix_index_publish_interval_s": 0.2,
                        "serve_router_cache_weight": CACHE_WEIGHT,
                        "metrics_report_interval_s": 0.5,
                        "trace_sample_rate": 1.0})
    yield info
    ray_tpu_torch.shutdown()


@pytest.fixture
def app(cluster):
    yield
    serve.shutdown()


def _jax_model():
    if "jax" not in _CACHE:
        jc = J.LlamaConfig.tiny(dtype=jnp.float32)
        jp = J.init_params(jc, jax.random.key(0))
        tree = jax.tree_util.tree_map(np.asarray, jp)
        _CACHE["jax"] = (jc, jp, tree)
    return _CACHE["jax"]


def _reference(prompt, n):
    key = (tuple(prompt), n)
    if key not in _CACHE:
        jc, jp, _ = _jax_model()
        _CACHE[key] = np.asarray(J.generate(
            jp, jnp.asarray([prompt], jnp.int32), jc,
            max_new_tokens=n))[0].tolist()
    return _CACHE[key]


def _loader(tree):
    """A zero-arg params_loader over the JAX package's numpy tree; it
    converts in the replica's process, which imports no JAX."""
    def load():
        import torch

        from ray_tpu_torch.models.convert import params_from_numpy
        from ray_tpu_torch.models.llama import LlamaConfig

        return params_from_numpy(
            tree, LlamaConfig.tiny(dtype=torch.float32), "cpu")
    return load


def _app_kwargs(**extra):
    return dict(model_config=T.LlamaConfig.tiny(dtype=torch.float32),
                quantize="bf16", params_loader=_loader(_jax_model()[2]),
                device="cpu", max_ongoing_requests=8, **extra)


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 256, n).tolist()


def _replicas(app_name, deployment):
    """The controller's replica handles of one deployment."""
    from ray_tpu_torch.serve._private.controller import (
        get_or_create_controller,
    )

    _, replicas = ray_tpu_torch.get(
        get_or_create_controller().get_replicas.remote(app_name,
                                                       deployment),
        timeout=60)
    return replicas


def _call(replica, method, *args):
    return ray_tpu_torch.get(
        replica.handle_request.remote(method, args, {}), timeout=60)


def _poll(fn, timeout=60.0, period=0.1):
    deadline = time.monotonic() + timeout
    while True:
        out = fn()
        if out or time.monotonic() > deadline:
            return out
        time.sleep(period)


def _probed(app):
    """Swap the app's router for a subclass that reports what its process
    holds: no KV payload and no CUDA state (the router forwards refs)."""
    from ray_tpu_torch.serve.llm import LLMRouter

    class ProbedRouter(LLMRouter):
        def probe(self):
            import gc as _gc
            import sys as _sys

            from ray_tpu_torch.serve.llm.kv_cache import KVPrefix, KVState

            held = [o for o in _gc.get_objects()
                    if isinstance(o, (KVState, KVPrefix))]
            tc = _sys.modules.get("torch")
            return {"kv_payloads": len(held),
                    "cuda_initialized": bool(
                        tc is not None and tc.cuda.is_initialized()),
                    "foreign": sorted(
                        m for m in _sys.modules
                        if m.split(".")[0] in ("jax", "ray_tpu"))}

    app.deployment = app.deployment.options(func_or_class=ProbedRouter)
    return app


def _viewed(app):
    """Swap the app's router for a subclass that reports its own view of
    the cluster prefix index: what a pick would score for a prompt."""
    from ray_tpu_torch.serve.llm import LLMRouter

    class ViewedRouter(LLMRouter):
        def view(self, prompt):
            from ray_tpu_torch.serve.llm.router import replica_tag

            with self._lock:
                ids = {replica_tag(r): i for r, i in self._index_id.items()}
            return {"fresh": self._index_age_s() <= self._index_ttl,
                    "hits": self._expected_hits(prompt), "index_ids": ids}

    app.deployment = app.deployment.options(func_or_class=ViewedRouter)
    return app


# ---------------------------------------------- policy against the reference


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_p2c_pick_matches_reference(seed):
    from ray_tpu.serve.llm.router import p2c_pick as ref_pick
    from ray_tpu_torch.serve.llm.router import p2c_pick

    names = [f"r{i}" for i in range(5)]
    load = {n: float((i * 7 + seed) % 4) for i, n in enumerate(names)}
    picks = {}
    for pick in (ref_pick, p2c_pick):
        rng = random.Random(seed)
        picks[pick] = [pick(names, load, rng) for _ in range(60)]
    assert picks[p2c_pick] == picks[ref_pick]
    rng = random.Random(0)
    assert [p2c_pick(["light", "heavy"], {"light": 0.0, "heavy": 5.0},
                     rng) for _ in range(40)] == ["light"] * 40


def _bare(router_cls, index=None, index_id=None, weight=0.25, ttl=60.0,
          replicas=None, inflight=None, depth=None):
    """An LLMRouter with only the routing-policy state (the reference
    tests' ``_bare_router``): no controller, no threads."""
    r = object.__new__(router_cls)
    r._lock = threading.Lock()
    index_id = dict(index_id or {})
    r._index = dict(index or {})
    r._index_at = time.monotonic()
    r._index_id = index_id
    r._cache_weight = weight
    r._index_ttl = ttl
    r._replicas = list(replicas if replicas is not None else index_id)
    r._inflight = dict(inflight or {h: 0 for h in r._replicas})
    r._depth = dict(depth or {h: 0.0 for h in r._replicas})
    r._pre_replicas, r._pre_inflight, r._pre_depth = [], {}, {}
    return r


def _routers():
    from ray_tpu.serve.llm.router import LLMRouter as RefRouter
    from ray_tpu_torch.serve.llm.router import LLMRouter

    return RefRouter, LLMRouter


def test_stalled_replica_sheds_traffic_as_in_the_reference():
    from ray_tpu_torch.serve.llm.router import p2c_pick

    out = []
    for cls in _routers():
        r = _bare(cls, replicas=["live", "stalled"],
                  inflight={"live": 3, "stalled": 0},
                  depth={"live": 2.0, "stalled": float("inf")})
        replicas, load = r._score()
        assert load["stalled"] == float("inf")
        rng = random.Random(1)
        out.append([p2c_pick(replicas, load, rng) for _ in range(25)])
    assert out[0] == out[1] == ["live"] * 25


def _family(seed):
    rng = random.Random(seed)
    return [rng.randrange(1, 200) for _ in range(3 * BS)]


def _index(stable_hash_prefix):
    fams = [_family(s) for s in range(4)]
    index = {f"iid{i}": {"heads": [(stable_hash_prefix(f[:j * BS]), j)
                                   for j in range(1, len(f) // BS + 1)],
                         "tiers": {"block_size": BS}, "age_s": 0.1}
             for i, f in enumerate(fams)}
    return fams, index, {f"rep{i}": f"iid{i}" for i in range(4)}


def test_expected_hits_longest_boundary_run_as_in_the_reference():
    from ray_tpu.serve.llm.kv_cache import stable_hash_prefix as ref_hash
    from ray_tpu_torch.serve.llm.kv_cache import stable_hash_prefix

    got = []
    for cls, h in zip(_routers(), (ref_hash, stable_hash_prefix)):
        fams, index, index_id = _index(h)
        r = _bare(cls, index, index_id)
        mutant = fams[1][:BS] + [0] * BS + fams[1][2 * BS:] + [7]
        got.append((r._expected_hits(fams[1] + [7]),
                    r._expected_hits(mutant), r._expected_hits(fams[1])))
    assert got[0] == got[1]
    full, mutant, exact = got[1]
    assert full == {"iid0": 0, "iid1": 3, "iid2": 0, "iid3": 0}
    assert mutant["iid1"] == 1 and exact["iid1"] == 2


def test_cache_aware_picks_and_stale_hold_as_in_the_reference():
    """The same Zipf-skewed family mix through both packages' scored p2c
    makes the same picks; a stale index (or weight 0) holds to plain
    p2c in both."""
    from ray_tpu.serve.llm.kv_cache import stable_hash_prefix as ref_hash
    from ray_tpu_torch.serve.llm.kv_cache import stable_hash_prefix

    runs = []
    for cls, h in zip(_routers(), (ref_hash, stable_hash_prefix)):
        fams, index, index_id = _index(h)
        r = _bare(cls, index, index_id, weight=0.25)
        rng = random.Random(42)
        random.seed(7)                       # p2c_pick's default rng
        weights = [1.0 / (i + 1) ** 1.3 for i in range(4)]
        picks, aware = [], 0
        for _ in range(200):
            fam = rng.choices(range(4), weights=weights)[0]
            prompt = fams[fam] + [rng.randrange(1, 200)]
            chosen, expected, outcome = r._pick_cached(prompt)
            assert outcome == "scored"
            picks.append(chosen)
            aware += expected.get(index_id[chosen], 0)
        stale = _bare(cls, index, index_id, weight=0.25, ttl=0.05)
        stale._index_at = time.monotonic() - 1.0
        off = _bare(cls, index, index_id, weight=0.0)
        runs.append((picks, aware, stale._pick_cached([1] * 25)[1:],
                     off._pick_cached([1] * 25)[1:]))
    assert runs[0] == runs[1]
    _, aware, stale, off = runs[1]
    assert aware >= 200
    assert stale == ({}, "held") and off == ({}, "held")


def test_replica_tag_is_free_of_commas():
    """A replica's actor id is bytes whose repr may hold a ',' (which a
    metric tag rejects); the port tags it by its hex."""
    from ray_tpu_torch.observability import serve_metrics
    from ray_tpu_torch.serve.llm.router import replica_tag

    class Handle:
        _actor_id = b"ab,\x00cd"

        def __repr__(self):
            return "ActorHandle(LLMServer, ab,cd)"

    h = Handle()
    assert "," in str(h._actor_id) and "," in repr(h)
    assert replica_tag(h) == b"ab,\x00cd".hex()
    serve_metrics().router_requests.inc(tags={"replica": replica_tag(h)})
    with pytest.raises(ValueError, match=","):
        serve_metrics().router_requests.inc(
            tags={"replica": str(h._actor_id)})


# ------------------------------------------------------------- the three apps


def test_build_llm_app_tokens_equal_jax_generate(app):
    from ray_tpu_torch.serve.llm import build_llm_app

    handle = serve.run(build_llm_app(engine_config=DENSE, **_app_kwargs()),
                       name="one")
    reqs = [(_prompt(s, n), m) for s, n, m in
            ((0, 3, 6), (1, 20, 8), (2, 16, 4), (3, 40, 7))]
    resps = [handle.remote({"prompt": p, "max_tokens": m}) for p, m in reqs]
    for (p, m), r in zip(reqs, resps):
        out = r.result(timeout=120)
        assert out["tokens"] == _reference(p, m)
        assert out["finish_reason"] == "length"
    st = handle.stats.remote().result(timeout=60)
    assert st["quantize"] == "bf16" and st["prefills"] == len(reqs)


def test_routed_app_tokens_and_both_replicas(app):
    """Two replicas behind the router: tokens equal generate's, both
    replicas take traffic, the counts add up, and the router's
    serve_router_requests_total tags are the replicas' hex ids."""
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.serve.llm import build_routed_llm_app
    from ray_tpu_torch.util.metrics import parse_labels

    handle = serve.run(build_routed_llm_app(
        engine_config=DENSE, num_replicas=2, probe_interval_s=0.1,
        **_app_kwargs()), name="routed")
    reqs = [(_prompt(10 + i, 2 + 5 * i), 4) for i in range(8)]
    resps = [handle.remote({"prompt": p, "max_tokens": m}) for p, m in reqs]
    outs = [r.result(timeout=120) for r in resps]
    for (p, m), out in zip(reqs, outs):
        assert out["tokens"] == _reference(p, m)
        assert len(out["x-trace-id"]) == 32
    st = handle.stats.remote().result(timeout=60)
    assert st["replicas"] == 2
    assert sum(st["routed"].values()) == len(reqs)
    assert len(st["routed"]) == 2            # both replicas took traffic
    ids = {r._actor_id.hex() for r in _replicas("routed", "llm")}
    assert set(st["routed"]) == ids

    def tagged():
        summary = global_worker().gcs.call(
            "user_metrics_summary", prefixes=["serve_router_requests"],
            timeout=10)
        data = summary.get("serve_router_requests_total", {}).get(
            "data", {})
        return {parse_labels(k)["replica"]: v for k, v in data.items()}

    # Every process pushes its own registry (this one holds the unit
    # case's tag above): read the routed replicas' series.
    tags = _poll(lambda: (lambda t: t if ids <= set(t) else None)(
        tagged()), timeout=30)
    assert tags, tagged()
    assert {k: int(tags[k]) for k in ids} == st["routed"]
    assert not any("," in k for k in tags)


@pytest.mark.parametrize("speculative", [False, True],
                         ids=["plain", "spec"])
def test_disagg_app_two_hop_through_the_store(app, speculative):
    """Prefill and decode pools: a prompt under the threshold is served
    whole by the decode pool, one over it goes two-hop (the prefill
    replica's result moves to the decode replica by ObjectRef), and a
    speculative decode pool gives the same tokens. The decode replica
    adopted the blocks; the router process never held a KV payload and
    has no CUDA state."""
    from ray_tpu_torch.serve.llm import build_disagg_llm_app

    threshold = 20
    kw = {"speculative": {"draft_seed": 0}} if speculative else {}
    handle = serve.run(_probed(build_disagg_llm_app(
        engine_config=PAGED, prefill_threshold=threshold,
        probe_interval_s=0.1, **_app_kwargs(**kw))),
        name="disagg")
    short, long_ = _prompt(20, 8), _prompt(21, 30)
    for p in (short, long_):
        out = handle.remote({"prompt": p, "max_tokens": 6}).result(
            timeout=180)
        assert out["tokens"] == _reference(p, 6)
    st = handle.stats.remote().result(timeout=60)
    assert st["lanes"] == {"interactive/decode": 1,
                           "interactive/prefill": 1}
    assert st["prefill_pool"]["replicas"] == 1
    (dec,) = _replicas("disagg", "llm-decode")
    dst = _call(dec, "stats")
    assert dst["migration"]["blocks"] == len(long_) // BS + 1
    if speculative:
        assert dst["spec"]["draft_prefills"] >= 2
    probe = handle.probe.remote().result(timeout=60)
    assert probe == {"kv_payloads": 0, "cuda_initialized": False,
                     "foreign": []}


# ------------------------------------------- cache-aware routing, pull, tier


def test_cache_aware_pick_and_peer_pull(app):
    """Two paged replicas with a prefix cache, publishing to the cluster
    index. A repeat of a prompt is routed "scored" to the replica that
    holds its prefix; with the holder busy on a long request, the next
    shared-prefix prompt goes to the other replica, which pulls the
    prefix from the holder through the object store, promotes every
    pulled block and prefills only the suffix; its tokens equal
    generate's."""
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.serve.llm import build_routed_llm_app
    from ray_tpu_torch.serve.llm.kv_cache import stable_hash_prefix
    from ray_tpu_torch.util import state

    engine = dict(PAGED, max_seq_len=512, prefill_buckets=(16, 64),
                  kv_prefill_cost_per_token_ms=50.0)
    handle = serve.run(_viewed(build_routed_llm_app(
        engine_config=engine, num_replicas=2, probe_interval_s=0.05,
        **_app_kwargs())), name="cached")
    shared = _prompt(30, 5 * BS)
    first = shared + _prompt(31, 4)

    def ask(prompt, n):
        return handle.remote({"prompt": prompt, "max_tokens": n})

    def settled():
        """The router sees both replicas idle (its probed depths lag a
        request's end by up to a probe period)."""
        st = handle.stats.remote().result(timeout=60)
        return (st["inflight"] == 0 and len(st["depth"]) == 2
                and not any(st["depth"].values()))

    out = ask(first, 4).result(timeout=120)
    assert out["tokens"] == _reference(first, 4)
    st = handle.stats.remote().result(timeout=60)
    (holder,) = st["routed"]
    head = stable_hash_prefix(shared)

    # Replicas of earlier apps stay in the index until its TTL: read
    # this app's.
    ids = {_call(r, "load")["index_id"] for r in _replicas("cached", "llm")}

    def indexed():
        idx = global_worker().gcs.call("lookup_prefix_index", timeout=10)
        held = [k for k in ids & set(idx)
                if head in {int(h) for h, _ in idx[k]["heads"]}]
        return idx if ids <= set(idx) and len(held) == 1 else None

    assert _poll(indexed), "both replicas in the index, one holding"

    def scores_holder():
        """The router's own view has caught up with the index: it knows
        both replicas' index ids, is fresh, and would score the holder's
        5 blocks of this prompt."""
        view = handle.view.remote(first).result(timeout=60)
        iid = view["index_ids"].get(holder)
        return (view["fresh"] and len(view["index_ids"]) == 2
                and iid is not None and view["hits"].get(iid) == 5)

    assert _poll(scores_holder), handle.view.remote(first).result(
        timeout=60)
    assert _poll(settled)
    out = ask(first, 4).result(timeout=120)
    assert out["tokens"] == _reference(first, 4)
    st = handle.stats.remote().result(timeout=60)
    assert st["routed"][holder] == 2
    assert st["cache_index"]["outcomes"]["scored"] >= 1
    assert st["cache_index"]["replicas_indexed"] >= 2

    assert _poll(settled)
    long_req = ask(shared + _prompt(32, 4), 400)      # the holder, busy
    assert _poll(lambda: handle.stats.remote().result(
        timeout=60)["inflight"] == 1, period=0.01)
    assert handle.stats.remote().result(timeout=60)["routed"][holder] == 3
    second = shared + _prompt(33, 4)
    out = ask(second, 4).result(timeout=120)
    st = handle.stats.remote().result(timeout=60)
    assert out["tokens"] == _reference(second, 4)
    (other,) = set(st["routed"]) - {holder}
    assert st["routed"][other] == 1
    assert st["cache_index"]["outcomes"]["pulled"] == 1
    receiver = next(r for r in _replicas("cached", "llm")
                    if r._actor_id.hex() == other)
    tiers = _call(receiver, "stats")["kv_tiers"]
    assert tiers["promoted_blocks"] == 5 and tiers["host"]["promotes"] == 5
    rows = _poll(lambda: state.list_serve_accounting(
        trace_id=out["x-trace-id"]))
    assert rows[0]["prefill_tokens_avoided"] == 5 * BS
    assert rows[0]["prefill_tokens_computed"] == len(second) - 5 * BS
    tree = _poll(lambda: (lambda t: t if t and t.get("complete") else None)(
        state.get_trace(out["x-trace-id"])))
    pulls = [c for c in tree["root"]["children"]
             if c["name"] == "kv.peer_pull"]
    assert len(pulls) == 1 and pulls[0]["attrs"]["blocks"] == 5
    long_out = long_req.result(timeout=300)
    assert long_out["num_tokens"] == 400


def test_store_tier_demotes_and_promotes(app):
    """A host tier smaller than one block: prefix blocks evicted from the
    pool demote straight to the object store, and a repeat of the prompt
    promotes them back from it; tokens equal generate's."""
    from ray_tpu_torch.serve.llm import build_llm_app

    engine = dict(PAGED, num_slots=2, max_seq_len=64, num_kv_blocks=6,
                  kv_host_tier_bytes=1, kv_prefill_cost_per_token_ms=50.0)
    handle = serve.run(build_llm_app(engine_config=engine, **_app_kwargs()),
                       name="tiered")
    a, b = _prompt(40, 28), _prompt(41, 28)
    for p in (a, b):
        out = handle.remote({"prompt": p, "max_tokens": 12}).result(
            timeout=120)
        assert out["tokens"] == _reference(p, 12)
    tiers = handle.stats.remote().result(timeout=60)["kv_tiers"]
    assert tiers["store"]["blocks"] >= 1 and tiers["host"]["blocks"] == 0
    assert tiers["store"]["spills"] == tiers["store"]["blocks"]
    parked = tiers["store"]["blocks"]
    out = handle.remote({"prompt": a, "max_tokens": 12}).result(timeout=120)
    assert out["tokens"] == _reference(a, 12)
    tiers = handle.stats.remote().result(timeout=60)["kv_tiers"]
    assert tiers["store"]["promotes"] == parked
    assert tiers["promoted_blocks"] >= parked
    assert tiers["dropped_blocks"] == 0


def test_pulled_links_are_copied_into_the_host_tier(cluster):
    """The zero-copy choice: a link gotten from the store is a view of
    the stored object; import_prefix parks a copy, so the tier pins no
    store extent and the object's mapping is released once the gotten
    value dies."""
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.serve.llm import LLMServer
    from ray_tpu_torch.serve.llm.kv_cache import KVPrefix

    cfg = T.LlamaConfig.tiny(dtype=torch.float32)
    server = LLMServer(cfg, dict(PAGED), quantize="bf16", device="cpu")
    try:
        shape = (cfg.n_layers, 1, BS, cfg.n_kv_heads, cfg.head_dim)
        n = 64                  # enough links for the object to leave
        toks = _prompt(50, n * BS)          # the inline size for the store
        gen = torch.Generator().manual_seed(0)
        links = [KVPrefix(tokens=tuple(toks[:j * BS]), block_size=BS,
                          k_blocks=torch.randn(shape, generator=gen),
                          v_blocks=torch.randn(shape, generator=gen))
                 for j in range(1, n + 1)]
        ref = ray_tpu_torch.put(links)
        got = ray_tpu_torch.get(ref, timeout=60)
        oid = ref.binary()
        w = global_worker()
        assert oid in w._mapped                      # a view of the store
        assert server.import_prefix(got) == n
        parked = list(server._engine._tiers._host.values())
        for p, g in zip(parked, got):
            for a, b in ((p.k_blocks, g.k_blocks), (p.v_blocks, g.v_blocks)):
                assert torch.equal(a, b)
                assert (a.untyped_storage().data_ptr()
                        != b.untyped_storage().data_ptr())
        del got, p, g, a, b
        gc.collect()
        assert oid not in w._mapped                  # no reader pin left
        assert len(server._engine._tiers._host) == n
    finally:
        server.shutdown()


# --------------------------------------------------------------- observability


def test_publish_serve_row_lands_in_the_gcs_ring(cluster):
    from ray_tpu_torch.observability.accounting import publish_serve_row
    from ray_tpu_torch.util import state

    row = {"tenant": "t-publish", "lane": "batch", "trace_id": "f" * 32,
           "tokens_out": 5, "chip_seconds": {"decode": 0.5},
           "chip_seconds_total": 0.5, "ttft_s": 0.1, "tpot_s": 0.01}
    assert publish_serve_row(row)
    rows = _poll(lambda: state.list_serve_accounting(tenant="t-publish"))
    assert len(rows) == 1 and rows[0]["tokens_out"] == 5
    assert rows[0]["node_id"] == ray_tpu_torch.nodes()[0]["NodeID"]
    assert state.serve_accounting(trace_id="f" * 32)["request"][
        "tenant"] == "t-publish"


def test_accounting_summary_equals_the_reference_ledger(cluster):
    """The GCS rollup over a fixed list of rows equals the reference's
    TenantLedger and SLOTracker folded over the same (ingested) rows."""
    from ray_tpu.observability.accounting import (
        SLOTracker as RefSLO, TenantLedger as RefLedger,
    )
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.util import state

    rng = np.random.RandomState(3)
    rows = [{"tenant": f"t-sum-{i % 3}", "lane": "lane-sum",
             "tokens_out": int(rng.randint(1, 50)),
             "prefill_tokens_computed": int(rng.randint(0, 100)),
             "prefill_tokens_avoided": int(rng.randint(0, 100)),
             "block_seconds": float(rng.rand()),
             "chip_seconds": {"prefill": 1e4 + float(rng.rand()),
                              "decode": 1e4 + float(rng.rand())},
             "chip_seconds_total": 2e4,
             "ttft_s": float(rng.rand()), "tpot_s": float(rng.rand() / 4)}
            for i in range(30)]
    global_worker().gcs.call("report_serve_accounting", rows=rows,
                             timeout=10)
    summary = state.serve_accounting(top_n=3)
    ingested = [r for r in state.list_serve_accounting(limit=4096)
                if r["lane"] == "lane-sum"]
    assert len(ingested) == len(rows)
    ledger, slo = RefLedger(max_tenants=64), RefSLO()
    for rec in ingested:
        ledger.fold(rec)
        slo.observe(rec["lane"], rec["ttft_s"], rec["tpot_s"])
    assert summary["tenants"] == ledger.top(3)
    assert summary["slo"]["lane-sum"] == slo.snapshot()["lane-sum"]
    assert summary["rows_recorded"] >= len(rows)


def test_routed_request_span_tree_matches_the_reference(app):
    """A routed request's trace, read back through util.state.get_trace:
    serve.request -> serve.replica_call -> llm.server_call -> llm.request
    with llm.queued and llm.decode below, parent links hop by hop (the
    tree of the reference's test_routed_llm_tracing_e2e)."""
    from ray_tpu_torch.serve.llm import build_routed_llm_app
    from ray_tpu_torch.util import state

    handle = serve.run(build_routed_llm_app(
        engine_config=DENSE, num_replicas=1, probe_interval_s=0.1,
        **_app_kwargs()), name="traced")
    out = handle.remote({"prompt": _prompt(60, 12),
                         "max_tokens": 8}).result(timeout=120)
    want = {"serve.request", "serve.replica_call", "llm.server_call",
            "llm.request", "llm.queued", "llm.decode"}

    def names(node):
        return {node["name"]}.union(*[names(c) for c in node["children"]])

    def tree():
        t = state.get_trace(out["x-trace-id"])
        return t if (t and t.get("complete") and t.get("root")
                     and want <= names(t["root"])) else None

    t = _poll(tree, timeout=30)
    assert t, state.get_trace(out["x-trace-id"])
    root = t["root"]

    def child(node, name):
        (c,) = [c for c in node["children"] if c["name"] == name]
        return c

    assert root["name"] == "serve.request"
    hop = child(root, "serve.replica_call")
    call = child(hop, "llm.server_call")
    req = child(call, "llm.request")
    assert {"llm.queued", "llm.decode"} <= {c["name"]
                                            for c in req["children"]}
    assert hop["parent_span_id"] == root["span_id"]
    assert call["parent_span_id"] == hop["span_id"]
    assert req["parent_span_id"] == call["span_id"]
    cp = state.trace_critical_path(out["x-trace-id"])
    assert cp["path"][0]["name"] == "serve.request"
    assert "serve.request" in {s["root_name"] for s in state.list_traces()}
    assert sys.modules.get("ray_tpu_torch.util.state") is state
