"""``observability.jit`` on the port: ``tracked_jit`` over eager callables,
held to the JAX package's ``tracked_jit``.

A trace on the port is the first call with a new argument signature, by
the rule under which JAX retraces (tensors and arrays by shape and dtype,
pytrees by structure, Python scalars abstract unless static, other
objects by value). So the same call sequence through both packages gives
the same traces, the same ``jit_stats`` and the same one
``RecompileWarning``; and the same requests through both packages'
``LLMEngine`` give the same ``stats()["traces"]`` and ``trace_count``,
dense and paged, with export, adopt, spill, promote and speculation.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import llama as J  # noqa: E402
from ray_tpu.observability import jit as RJ  # noqa: E402
from ray_tpu.serve.llm import engine as JE  # noqa: E402
from ray_tpu_torch.models import llama as T  # noqa: E402
from ray_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from ray_tpu_torch.observability import jit as PJ  # noqa: E402
from ray_tpu_torch.serve.llm import engine as E  # noqa: E402


# ------------------------------------------------- the retrace rule

def _arr(pkg, shape, dtype="float32"):
    a = np.ones(shape, dtype)
    if pkg == "jax":
        return jnp.asarray(a)
    return torch.from_numpy(a)


def _bf16(pkg, shape):
    if pkg == "jax":
        return jnp.ones(shape, jnp.bfloat16)
    return torch.ones(shape, dtype=torch.bfloat16)


# Each sequence: (static_argnums, [call argument builders]). The function
# sums what it is given, so both frameworks run every call.
SEQUENCES = {
    "shapes_and_dtypes": ((), [
        lambda p: (_arr(p, (8, 8)),),
        lambda p: (_arr(p, (8, 8)),),
        lambda p: (_arr(p, (16, 8)),),
        lambda p: (_bf16(p, (8, 8)),),
        lambda p: (_arr(p, (16, 8)),),
        lambda p: (_arr(p, (4,), "int32"),),
    ]),
    "weak_scalars": ((), [
        lambda p: (_arr(p, (4,)), 2.0),
        lambda p: (_arr(p, (4,)), 3.5),
        lambda p: (_arr(p, (4,)), 3),
        lambda p: (_arr(p, (4,)), 7),
        lambda p: (_arr(p, (4,)), True),
        lambda p: (_arr(p, (4,)), np.int32(3)),
        lambda p: (_arr(p, (4,)), np.int32(4)),
    ]),
    "static_values": ((1,), [
        lambda p: (_arr(p, (4,)), 2),
        lambda p: (_arr(p, (4,)), 2),
        lambda p: (_arr(p, (4,)), 3),
        lambda p: (_arr(p, (4,)), 3),
        lambda p: (_arr(p, (4,)), 4),
    ]),
    "pytrees": ((), [
        lambda p: ({"a": _arr(p, (2,)), "b": _arr(p, (3,))},),
        lambda p: ({"b": _arr(p, (3,)), "a": _arr(p, (2,))},),
        lambda p: ({"a": _arr(p, (2,)), "b": _arr(p, (4,))},),
        lambda p: ([_arr(p, (2,)), _arr(p, (2,))],),
        lambda p: ((_arr(p, (2,)), _arr(p, (2,))),),
        lambda p: ([_arr(p, (2,)), _arr(p, (2,)), _arr(p, (2,))],),
        lambda p: ({"a": _arr(p, (2,)), "b": _arr(p, (3,))},),
    ]),
    "numpy_arguments": ((), [
        lambda p: (np.zeros((8,), np.int32),),
        lambda p: (np.ones((8,), np.int32),),
        lambda p: (np.zeros((16,), np.int32),),
        lambda p: (np.zeros((8,), np.int64),),
    ]),
}


def _body(pkg):
    lib = jnp if pkg == "jax" else torch

    def total(x, *rest):
        leaves = (jax.tree_util.tree_leaves(x) if pkg == "jax"
                  else torch.utils._pytree.tree_leaves(x))
        out = sum(lib.sum(lib.asarray(leaf) if pkg == "jax"
                          else torch.as_tensor(leaf)) for leaf in leaves)
        for r in rest:
            if not isinstance(r, (bool, int, float, np.generic)):
                continue
            out = out + float(r)
        return out

    return total


def _run_sequence(pkg, name):
    mod = RJ if pkg == "jax" else PJ
    static, calls = SEQUENCES[name]
    fn_name = f"jit_parity_{name}_{pkg}"
    f = mod.tracked_jit(_body(pkg), name=fn_name, trace_budget=3,
                        static_argnums=static)
    traces = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for build in calls:
            f(*build(pkg))
            traces.append(f.traces)
    warned = [str(w.message) for w in caught
              if issubclass(w.category, mod.RecompileWarning)]
    stats = mod.jit_stats()[fn_name]
    return {"traces": traces, "calls": f.calls,
            "stats": (stats["traces"], stats["compiles"]),
            "warnings": len(warned),
            "warned_name": all(fn_name in w for w in warned)}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_call_sequence_traces_as_the_reference(name):
    want, got = _run_sequence("jax", name), _run_sequence("torch", name)
    assert got == want


def test_budget_warns_once_with_the_signature():
    f = PJ.tracked_jit(lambda x: x * 2, name="jit_budget_probe",
                       trace_budget=1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for n in (2, 3, 4, 5):
            f(torch.ones(n))
    msgs = [str(w.message) for w in caught
            if issubclass(w.category, PJ.RecompileWarning)]
    assert len(msgs) == 1
    assert "jit_budget_probe" in msgs[0] and "float32[3]" in msgs[0]
    assert PJ.jit_stats()["jit_budget_probe"]["traces"] == 4


def test_aot_surface_never_inflates_the_counters():
    """eval_shape runs the raw function on fake tensors and counts
    nothing; compiled() returns a called signature's captured counts and
    None for one never called; lower raises in eager PyTorch; clear_cache
    makes the next call trace again."""
    f = PJ.tracked_jit(lambda a, b: a @ b, name="jit_aot_probe",
                       trace_budget=0)
    x = torch.ones((8, 8))
    shape = f.eval_shape(x, x)
    assert shape.shape == (8, 8) and shape.device.type == "meta"
    assert f.traces == 0 and f.compiled(x, x) is None
    f(x, x)
    art = f.compiled(x, x)
    assert f.traces == 1 and art is not None
    assert art.cost_analysis()["flops"] == 2 * 8 ** 3
    assert f.compiled(x, x) is art
    with pytest.raises(NotImplementedError, match="eager PyTorch"):
        f.lower(x, x)
    f.clear_cache()
    f(x, x)
    assert f.traces == 2 and f.compiled(x, x) is not art


def test_unknown_jit_keyword_raises():
    with pytest.raises(TypeError, match="unexpected keyword"):
        PJ.tracked_jit(lambda x: x, name="bad", bogus=1)
    # The reference's keywords are accepted: donation changes nothing.
    f = PJ.tracked_jit(lambda x: x + 1, donate_argnums=(0,))
    assert int(f(torch.ones(()))) == 2


# ---------------------------------------------------- the engines

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
        _CACHE["model"] = (jc, jp, tc,
                           params_from_numpy(_np_tree(jp), tc, "cpu"))
    return _CACHE["model"]


def _engine(pkg, geo, draft=False):
    jc, jp, tc, tp = _model()
    if pkg == "jax":
        kw = dict(draft_params=jp, draft_config=jc) if draft else {}
        return JE.LLMEngine(jp, jc, JE.EngineConfig(**geo), **kw)
    kw = dict(draft_params=tp, draft_config=tc) if draft else {}
    return E.LLMEngine(tp, tc, E.EngineConfig(**geo), device="cpu", **kw)


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 256, n).tolist()


def _serve(pkg, eng, lengths, max_tokens=4, **kw):
    mod = JE if pkg == "jax" else E
    handles = [eng.submit(mod.Request(prompt=_prompt(100 + i, n),
                                      max_tokens=max_tokens, **kw))
               for i, n in enumerate(lengths)]
    eng.drain()
    return handles


def _dense(pkg):
    eng = _engine(pkg, dict(num_slots=2, max_seq_len=64,
                            prefill_buckets=(8, 16)))
    _serve(pkg, eng, (5, 12, 3))
    _serve(pkg, eng, (14,))
    return [eng]


_PAGED = dict(num_slots=3, max_seq_len=96, prefill_buckets=(16, 32),
              kv_layout="paged", kv_block_size=8, decode_block=1)


def _paged_migration(pkg):
    """Prefill-only requests export their KV; a second engine adopts
    them; the donor serves a prefix pull."""
    src, dst = _engine(pkg, _PAGED), _engine(pkg, _PAGED)
    mod = JE if pkg == "jax" else E
    handles = _serve(pkg, src, (14, 20, 9), prefill_only=True)
    for h in handles:
        dst.submit_adopted(mod.Request(prompt=list(h.request.prompt),
                                       max_tokens=4), h.kv_state)
    dst.drain()
    _serve(pkg, src, (30,))
    src.export_prefix(_prompt(103, 30) + [1, 2])
    return [src, dst]


def _paged_tiers(pkg):
    """A small pool with a host tier: prefixes spill on eviction and a
    repeated prompt promotes them back."""
    geo = dict(_PAGED, num_slots=2, num_kv_blocks=12, kv_spill=True,
               kv_host_tier_bytes=1 << 24,
               kv_prefill_cost_per_token_ms=50.0)
    eng = _engine(pkg, geo)
    for seed in range(4):
        _serve(pkg, eng, (24,), max_tokens=2)
        mod = JE if pkg == "jax" else E
        eng.submit(mod.Request(prompt=_prompt(200 + seed, 24),
                               max_tokens=2))
        eng.drain()
    eng.submit((JE if pkg == "jax" else E).Request(
        prompt=_prompt(200, 24), max_tokens=2))
    eng.drain()
    return [eng]


def _paged_spec(pkg):
    eng = _engine(pkg, dict(_PAGED, spec_k=3), draft=True)
    _serve(pkg, eng, (10, 20), max_tokens=6)
    return [eng]


SCENARIOS = {"dense": _dense, "paged_migration": _paged_migration,
             "paged_tiers": _paged_tiers, "paged_spec": _paged_spec}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_traces_match_the_reference(scenario):
    def traces(pkg):
        return [(e.stats()["traces"], e.trace_count)
                for e in SCENARIOS[scenario](pkg)]

    want, got = traces("jax"), traces("torch")
    assert got == want
    for per_family, count in got:
        assert count == sum(per_family.values())


def test_migration_scenario_runs_export_and_adopt():
    """The migration scenario reaches the programs it is there for."""
    (src_traces, _), (dst_traces, _) = [
        (e.stats()["traces"], e.trace_count)
        for e in _paged_migration("torch")]
    assert src_traces["export"] == 1
    assert dst_traces["adopt"] == 1


def test_server_stats_carry_the_engine_programs():
    from ray_tpu_torch.serve.llm import LLMServer

    server = LLMServer(T.LlamaConfig.tiny(dtype=torch.float32),
                       dict(num_slots=2, max_seq_len=64,
                            prefill_buckets=(8, 16)),
                       device="cpu")
    try:
        server({"prompt": [1, 2, 3], "max_tokens": 3})
        stats = server.stats()
    finally:
        server.shutdown()
    assert stats["traces"] == {"tick": 1, "insert": 1}
    assert stats["trace_count"] == 2
    assert {"llm_engine_tick", "llm_engine_insert"} <= set(stats["jit"])
    assert stats["jit"]["llm_engine_tick"]["compiles"] >= 1
