"""The port's KV bookkeeping (``ray_tpu_torch.serve.llm.kv_cache``) against
the reference's (``ray_tpu.serve.llm.kv_cache``): the same seeded sequence
of allocator, prefix-cache and tier operations on both gives identical
results and ``stats()``. Block payloads are numpy arrays on the
reference's side and CPU tensors of the same shape and type on the
port's, so byte accounting is the same.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ray_tpu.serve.llm import kv_cache as R  # noqa: E402
from ray_tpu_torch.serve.llm import kv_cache as P  # noqa: E402

BS = 4
PAYLOAD = (2, 1, BS, 2, 8)          # [L, 1 block, bs, n_kv, hd]


def _payload(mod, value):
    if mod is R:
        return np.full(PAYLOAD, value, np.float32)
    return torch.full(PAYLOAD, float(value), dtype=torch.float32)


def _value(x):
    """A comparable form of an operation's result."""
    if isinstance(x, list):
        return [_value(v) for v in x]
    if isinstance(x, tuple):
        return tuple(_value(v) for v in x)
    if isinstance(x, (R.TierHit, P.TierHit)):
        return ("hit", x.key, x.tier, tuple(x.prefix.tokens),
                float(x.prefix.k_blocks[0, 0, 0, 0, 0]))
    return x


class _World:
    """One package's allocator, prefix cache and host tier, with the
    spill hook the engine installs (one single-block KVPrefix per
    evicted chain link)."""

    def __init__(self, mod, num_blocks=24, host_budget=6):
        self.mod = mod
        self.alloc = mod.BlockAllocator(num_blocks, BS, block_bytes=64)
        self.prefix = mod.PrefixCache(self.alloc, max_blocks=16)
        nbytes = 2 * int(np.prod(PAYLOAD)) * 4
        self.tiers = mod.KVTierManager(host_budget * nbytes, BS)
        self.prefix.spill_fn = self.spill
        self.live = []                  # block lists this world holds

    def spill(self, victims):
        ents = [e for e in victims if e.tokens]
        return self.tiers.spill([
            self.mod.KVPrefix(tokens=e.tokens, block_size=BS,
                              k_blocks=_payload(self.mod, e.block),
                              v_blocks=_payload(self.mod, -e.block))
            for e in ents])


def _prompts(rng, n):
    """Prompts sharing prefixes: a few roots, extended at random."""
    roots = [rng.randint(0, 50, 3 * BS).tolist() for _ in range(3)]
    out = []
    for _ in range(n):
        r = roots[rng.randint(len(roots))]
        cut = rng.randint(1, len(r) + 1)
        out.append(r[:cut] + rng.randint(0, 50, rng.randint(0, 2 * BS))
                   .tolist())
    return out


def _step(w, op, arg):
    a, p, t = w.alloc, w.prefix, w.tiers
    if op == "alloc":
        got = a.alloc(arg)
        if got is not None:
            w.live.append(got)
        return got
    if op == "free":
        if not w.live:
            return None
        blocks = w.live.pop(arg % len(w.live))
        a.free(blocks)
        return blocks
    if op == "fork":
        if not w.live:
            return None
        child = a.fork(w.live[arg % len(w.live)])
        w.live.append(child)
        return child
    if op == "cow":
        if not w.live:
            return None
        blocks = w.live[arg % len(w.live)]
        if not blocks:
            return None
        new, copy = a.copy_on_write(blocks[0])
        blocks[0] = new
        return (new, copy)
    if op == "match":
        got = p.match(arg, max_blocks=(len(arg) - 1) // BS)
        w.live.append(got)
        return got
    if op == "insert":
        if not w.live:
            return None
        blocks = w.live[-1]
        p.insert(arg, blocks)
        return len(p)
    if op == "evict":
        return p.evict(arg)
    if op == "lookup":
        return t.lookup(arg, BS, start_depth=0)
    if op == "pop":
        hits = t.lookup(arg, BS, start_depth=0)
        t.pop(hits[:2])
        return hits[:2]
    if op == "adopt":
        got = a.adopt(arg, p)
        if got is not None:
            w.live.append(got)
        return got
    if op == "donate":
        if not w.live:
            return None
        blocks = w.live.pop(arg % len(w.live))
        a.donate(blocks)
        return blocks
    raise AssertionError(op)


def _run(mod, seed, n_ops):
    rng = np.random.RandomState(seed)
    prompts = _prompts(rng, 12)
    w = _World(mod)
    trace = []
    ops = ("alloc", "free", "fork", "cow", "match", "insert", "evict",
           "lookup", "pop", "adopt", "donate")
    for _ in range(n_ops):
        op = ops[rng.randint(len(ops))]
        if op in ("alloc", "adopt"):
            arg = int(rng.randint(1, 7))
        elif op == "evict":
            arg = int(rng.randint(1, 4))
        elif op in ("match", "insert", "lookup", "pop"):
            arg = prompts[rng.randint(len(prompts))]
        else:
            arg = int(rng.randint(100))
        try:
            res = ("ok", _value(_step(w, op, arg)))
        except Exception as e:           # both must raise the same way
            res = ("raised", type(e).__name__)
        trace.append((op, res))
    stats = (w.alloc.stats(), w.prefix.stats(), w.tiers.stats(),
             len(w.prefix), len(w.tiers),
             [w.alloc.refcount(b) for b in range(w.alloc.num_blocks)],
             w.prefix.snapshot_heads(), w.tiers.stable_heads())
    return trace, stats


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_kv_cache_matches_reference(seed):
    r_trace, r_stats = _run(R, seed, 300)
    p_trace, p_stats = _run(P, seed, 300)
    for i, (r, p) in enumerate(zip(r_trace, p_trace)):
        assert r == p, (i, r, p)
    assert p_stats == r_stats
    ops = {op for op, res in p_trace if res[0] == "ok" and res[1]}
    assert {"alloc", "match", "evict", "lookup"} <= ops
    assert p_stats[1]["spilled"] > 0 and p_stats[2]["dropped_blocks"] > 0


def test_kv_state_and_prefix_take_cpu_tensors():
    """The port's payloads are CPU tensors: shape, nbytes and validation
    work as the reference's do on numpy."""
    kb = torch.zeros((2, 3, BS, 2, 8), dtype=torch.bfloat16)
    st = P.KVState(prompt=list(range(10)), tokens=[5, 6], next_tok=6,
                   pos=11, temperature=0.0, block_size=BS, k_blocks=kb,
                   v_blocks=kb.clone())
    st.validate()
    assert st.n_blocks == 3 and st.payload_bytes == 2 * kb.numel() * 2
    with pytest.raises(ValueError):
        P.KVState(prompt=[1] * 10, tokens=[5], next_tok=5, pos=13,
                  temperature=0.0, block_size=BS, k_blocks=kb,
                  v_blocks=kb).validate()
    pre = P.KVPrefix(tokens=tuple(range(2 * BS)), block_size=BS,
                     k_blocks=kb[:, 1:2], v_blocks=kb[:, 1:2])
    pre.validate()
    assert pre.payload_bytes == 2 * BS * 2 * 8 * 2 * 2
    assert P.stable_hash_prefix([1, 2, 3]) == R.stable_hash_prefix([1, 2, 3])


# The serve engine's settings (its paged pool, preemption gate,
# speculative depth, KV tiers, prefix-index cap, accounting and SLOs).
SERVE_KNOBS = {
    "serve_kv_block_size", "serve_preempt_hold_s", "serve_preempt_cooldown_s",
    "serve_spec_k", "serve_kv_host_tier_bytes",
    "serve_kv_adopt_cost_fixed_ms", "serve_kv_adopt_cost_per_block_ms",
    "serve_kv_prefill_cost_per_token_ms", "serve_prefix_index_max_heads",
    "serve_accounting_instrumentation", "serve_accounting_max_tenants",
    "serve_slo_ttft_ms", "serve_slo_tpot_ms", "serve_slo_objective",
    "serve_slo_burn_fast_window_s", "serve_slo_burn_slow_window_s",
    "serve_slo_burn_threshold", "serve_slo_min_samples",
}


def test_port_config_and_hysteresis_match_reference(monkeypatch):
    """The config table, serve knobs included: a part of the reference's
    with its types, defaults and RAY_TPU_ overrides; the Hysteresis
    gate: the reference's decisions on one sequence."""
    from ray_tpu._private.config import _REGISTRY as REF_REGISTRY
    from ray_tpu._private.config import GlobalConfig as RC
    from ray_tpu.observability.control import Hysteresis as RH
    from ray_tpu_torch._private.config import _REGISTRY
    from ray_tpu_torch._private.config import GlobalConfig as PC
    from ray_tpu_torch.observability.control import Hysteresis as PH

    assert set(_REGISTRY) <= set(REF_REGISTRY)
    assert SERVE_KNOBS <= set(_REGISTRY)
    # The tables, not the resolved values: a cluster started earlier in
    # this process may have loaded a _system_config into either one.
    for name, entry in _REGISTRY.items():
        ref = REF_REGISTRY[name]
        assert (entry.type, entry.default) == (ref.type, ref.default), name
    monkeypatch.setenv("RAY_TPU_serve_spec_k", "6")
    assert PC.serve_spec_k == 6 == RC.serve_spec_k
    rh, ph = RH(0.5, 0.2, 1.0), PH(0.5, 0.2, 1.0)
    rng = np.random.RandomState(0)
    now, cur = 100.0, 0
    for _ in range(200):
        now += float(rng.uniform(0, 0.4))
        want = int(rng.randint(0, 3))
        r, p = rh.propose(cur, want, now), ph.propose(cur, want, now)
        assert r == p
        cur = r
