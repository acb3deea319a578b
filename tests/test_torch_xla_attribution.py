"""The program plane on the port (``observability.xla``, ``chipspec``, the
``TrackedJit`` capture and sample hooks, the GCS program ring and
``/api/programs``), held to the JAX package's.

Unit tier: both chip-spec tables on the shared kinds, and the H100 row;
both ``ProgramRegistry``s fed the same cost artifacts (the reference
tests' stub shapes) give equal rows, MFU, MBU, verdicts, headroom and
sentinel events; a hand kernel counts its formula on its plain path
(B1, B2 + B3, the rings), so a program counts the same on the CPU as on
the card; a tiny engine's insert counts exactly the analytic FLOPs
(matmuls plus B1's), the reference's XLA count printed beside it.

Cluster tier (one port cluster for the module): the reference's ring
cases (list, summary, bound, malformed rows), a real tiny engine's
programs landing in the fleet summary, the shape-drift recompile's one
PERF_REGRESSION, ``GET /api/programs`` and the metric exposition.
"""

import json
import math
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ray_tpu_torch.observability import chipspec as PC  # noqa: E402
from ray_tpu_torch.observability import xla as PX  # noqa: E402


# ---------------------------------------------------------- chip specs

SHARED_KINDS = ["TPU v5 lite", "TPU v5e", "TPU v5p", "TPU v5", "TPU v4",
                "TPU v5litepod-8", "cpu", "Gaudi 3", "", None]


@pytest.mark.parametrize("kind", SHARED_KINDS)
def test_lookup_matches_reference(kind):
    from ray_tpu.observability import chipspec as RC

    want, got = RC.lookup(kind), PC.lookup(kind)
    assert (got.spec, got.peak_flops, got.peak_hbm_bytes_per_s,
            got.measurement, got.known) == (
        want.spec, want.peak_flops, want.peak_hbm_bytes_per_s,
        want.measurement, want.known)


@pytest.mark.parametrize("name", ["NVIDIA H100 80GB HBM3", "NVIDIA H100",
                                  "H100 SXM5", "nvidia h100 pcie"])
def test_h100_row_resolves(name):
    spec = PC.lookup(name)
    assert spec.spec == "h100" and spec.measurement == "gpu"
    assert spec.peak_flops == 989e12
    assert spec.peak_hbm_bytes_per_s == 3.35e12


def test_cpu_process_resolves_to_the_nominal_row():
    # No CUDA context here: the local spec is the plumbing-only CPU row,
    # and asking never creates a context.
    assert PC.local_spec().measurement == "cpu"
    assert PC.spec_for_device(torch.device("cpu")).spec == "cpu"
    assert PC.spec_for_device("xpu:0") is PC.UNKNOWN
    assert not torch.cuda.is_initialized()


# --------------------------------------------------------- registries

class _FakeMem:
    def __init__(self, arg=1024, out=512, temp=256, alias=0):
        self.argument_size_in_bytes = arg
        self.output_size_in_bytes = out
        self.temp_size_in_bytes = temp
        self.alias_size_in_bytes = alias


class _FakeCompiled:
    """The reference tests' stand-in for a compiled artifact."""

    def __init__(self, flops, bytes_accessed=1e5, mem=None):
        self._cost = {"flops": float(flops),
                      "bytes accessed": float(bytes_accessed),
                      "transcendentals": 0.0}
        self._mem = mem or _FakeMem()

    def cost_analysis(self):
        return [self._cost]          # the CPU-backend list shape

    def memory_analysis(self):
        return self._mem


# Each step: ("compile", fn, sig, flops, bytes, mem kwargs) or
# ("sample", fn, sig, wall, exposed).
SCENARIOS = {
    "recompile_drift": [
        ("compile", "drift_fn", "sigA", 1000, 1e5, {}),
        ("compile", "drift_fn", "sigB", 8000, 1e5, {}),
        ("compile", "drift_fn", "sigC", 16000, 1e5, {}),
        ("compile", "drift_fn", "sigD", 1100, 1e5, {}),
        ("compile", "drift_fn", "sigE", 9000, 1e5, {}),
    ],
    "dimensions_independent": [
        ("compile", "mem_fn", "sigA", 1000, 1e5, {}),
        ("compile", "mem_fn", "sigB", 1000, 1e5,
         dict(arg=10240, out=5120, temp=2560)),
    ],
    "wall_drift": [("compile", "wall_fn", "sig", 1000, 1e5, {}),
                   ("sample", "wall_fn", "sig", 0.01, 0.0)]
    + [("sample", "wall_fn", "sig", 0.1, 0.0)] * 6,
    "compute_bound": [("compile", "mm_fn", "sig", 5e12, 1e9, {}),
                      ("sample", "mm_fn", "sig", 0.5, 0.0),
                      ("sample", "mm_fn", "sig", 0.3, 0.0)],
    "memory_bound": [("compile", "copy_fn", "sig", 1e6, 5e10, {}),
                     ("sample", "copy_fn", "sig", 0.8, 0.0)],
    "comm_bound": [("compile", "ar_fn", "sig", 1e9, 1e9, {}),
                   ("sample", "ar_fn", "sig", 0.2, 0.15),
                   ("sample", "ar_fn", "sig", 0.2, 0.01)],
    "unknown_program_sample": [("sample", "ghost", "sig", 0.5, 0.0)],
}

_VOLATILE = ("pid", "ts")


def _drive(mod, steps, monkeypatch):
    fired = []
    monkeypatch.setattr(
        mod, "_emit_regression",
        lambda fn, row, dim, ratio, base, cur: fired.append(
            (fn, dim, ratio, base, cur)))
    monkeypatch.setattr(mod, "_publish_row", lambda row: False)
    reg = mod.ProgramRegistry()
    out = []
    for step in steps:
        if step[0] == "compile":
            _, fn, sig, flops, nbytes, mem = step
            row = reg.record_compile(
                fn, sig, _FakeCompiled(flops, nbytes, _FakeMem(**mem)), 0.1,
                calls=10)
        else:
            _, fn, sig, wall, exposed = step
            row = reg.record_sample(fn, sig, wall, exposed_comm_s=exposed,
                                    calls=20)
        out.append(None if row is None else
                   {k: v for k, v in row.items() if k not in _VOLATILE})
    baselines = {fn: reg.baseline(fn) for fn in {s[1] for s in steps}}
    return out, fired, baselines


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_registry_matches_reference(scenario, monkeypatch):
    """The same artifacts and walls through both registries: the same
    rows (MFU, MBU, verdict, headroom included), baselines and sentinel
    events. Rows name the nominal cpu spec on both sides here."""
    from ray_tpu.observability import xla as RX

    want = _drive(RX, SCENARIOS[scenario], monkeypatch)
    got = _drive(PX, SCENARIOS[scenario], monkeypatch)
    assert got == want


def test_sentinel_fires_once_per_episode(monkeypatch):
    _, fired, _ = _drive(PX, SCENARIOS["recompile_drift"], monkeypatch)
    assert [(f[0], f[1]) for f in fired] == [("drift_fn", "flops")] * 2
    assert fired[0][2] == pytest.approx(8.0)


def test_ratio_zero_disables_the_sentinel(monkeypatch):
    monkeypatch.setenv("RAY_TPU_xla_regression_ratio", "0")
    _, fired, _ = _drive(PX, SCENARIOS["recompile_drift"], monkeypatch)
    assert fired == []


def test_cpu_memory_fields_are_none_not_a_guess(monkeypatch):
    """A program captured on the CPU has no allocator peak: its temp and
    peak bytes are None, and the peak-bytes sentinel skips it."""
    monkeypatch.setattr(PX, "_publish_row", lambda row: False)
    f = PX.program_registry()
    f.clear()
    from ray_tpu_torch.observability.jit import tracked_jit

    g = tracked_jit(lambda a: a * 2, name="cpu_mem_probe", trace_budget=0)
    x = torch.ones((32, 32))
    g(x)
    row = [r for r in f.rows() if r["fn"] == "cpu_mem_probe"][0]
    assert row["arg_bytes"] == row["out_bytes"] == 32 * 32 * 4
    assert row["temp_bytes"] is None and row["peak_hbm_bytes"] is None
    assert row["spec"] == "cpu" and row["measurement"] == "cpu"
    f.clear()


# ---------------------------------------------------------- kernel counts

def _counted(fn, *args, **kwargs):
    with PX.count_costs(args, kwargs) as c:
        out = fn(*args, **kwargs)
        c.finish(out)
    return c


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,D", [(128, 16), (256, 64), (200, 128)])
def test_b1_counts_its_formula_on_the_plain_path(S, D, dtype):
    """B1's plain version (what runs on the CPU) counts B1's formula, the
    one its bound uses, and none of its own aten ops: two products of
    2 * D flops per visible pair, q, k, v read and O and the f32 LSE
    written once, one exp per visible pair."""
    from ray_tpu_torch.ops.attention import flash_attention

    B, H = 2, 3
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((B, S, H, D), generator=gen).to(dtype)
               for _ in range(3))
    c = _counted(flash_attention, q, k, v, causal=True)
    pairs = B * H * S * (S + 1) // 2
    elem = torch.finfo(dtype).bits // 8
    assert c.flops == 4.0 * D * pairs
    assert c.bytes == 4 * B * S * H * D * elem + 4 * B * H * S
    assert c.transcendentals == pairs


def test_b2_b3_count_their_formulas_on_the_plain_path():
    from ray_tpu_torch.ops.attention import (flash_attention,
                                             flash_attention_bwd)

    B, S, H, D = 1, 128, 2, 32
    gen = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn((B, S, H, D), generator=gen)
                   for _ in range(4))
    out, lse = flash_attention(q, k, v, return_lse=True)
    c = _counted(flash_attention_bwd, q, k, v, out, lse, do)
    pairs = B * H * S * (S + 1) // 2
    assert c.flops == (4 + 3) * 2.0 * D * pairs
    read = 4 * B * S * H * D * 4 + 2 * B * H * S * 4
    assert c.bytes == (read + 2 * B * S * H * D * 4) + (
        read + B * S * H * D * 4)


@pytest.mark.parametrize("kernel", ["allreduce", "reduce_scatter",
                                    "allgather", "permute", "qallreduce",
                                    "qhop"])
def test_ring_kernels_count_their_bytes_on_the_plain_path(kernel):
    from ray_tpu_torch.util.collective import quantized as Q
    from ray_tpu_torch.util.collective import ring as R

    n, rows = 4, 8
    x = torch.randn((n, n * rows, 128))
    fn, moved = {
        "allreduce": (R.ring_allreduce_plain, 2 * x.nbytes),
        "reduce_scatter": (R.ring_reduce_scatter_plain,
                           x.nbytes + x.nbytes / n),
        "allgather": (R.ring_allgather_plain, x.nbytes * (1 + n)),
        "permute": (R.ring_permute_plain, 2 * x.nbytes),
        "qallreduce": (Q.ring_qallreduce_plain, 2 * x.nbytes),
        "qhop": (Q.ring_qhop_plain, 2 * x.nbytes),
    }[kernel]
    c = _counted(fn, x)
    assert c.flops == 0.0 and c.bytes == moved


def test_tiny_insert_counts_the_analytic_flops(capsys):
    """A tiny dense engine's insert at bucket 128 (B1's path) counts
    exactly its matmuls plus B1's formula plus the first token's
    lm-head row. The reference's XLA count of the same program is printed
    beside it (XLA also counts elementwise work), not gated."""
    from ray_tpu_torch.models import llama as T
    from ray_tpu_torch.serve.llm import engine as E

    cfg = T.LlamaConfig.tiny(dtype=torch.float32, attn_impl="flash",
                             max_seq_len=256)
    geo = dict(num_slots=1, max_seq_len=256, prefill_buckets=(128,))
    params = T.init_params(cfg, seed=0, device="cpu")
    eng = E.LLMEngine(params, cfg, E.EngineConfig(**geo), device="cpu")
    eng.submit(E.Request(prompt=list(range(1, 101)), max_tokens=2))
    eng.drain()
    rows = [r for r in PX.program_registry().rows()
            if r["fn"] == "llm_engine_insert"
            and r["signature"].startswith("(int64[128]")]
    assert rows, PX.program_registry().rows()
    P, D, H, KV, hd, F, V = (128, cfg.dim, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim, cfg.hidden_dim, cfg.vocab_size)
    per_layer = (2 * P * D * (H * hd + 2 * KV * hd) + 2 * P * H * hd * D
                 + 3 * 2 * P * D * F + 4.0 * hd * H * P * (P + 1) // 2)
    analytic = cfg.n_layers * per_layer + 2 * D * V
    assert rows[-1]["flops"] == analytic
    ref = _reference_insert_flops()
    with capsys.disabled():
        print(f"\n[tiny insert, bucket 128] port {rows[-1]['flops']:.0f} "
              f"flops (analytic {analytic:.0f}); reference XLA "
              f"cost_analysis {ref}")


def _reference_insert_flops():
    """The reference engine's XLA count of the same insert (attention by
    its plain XLA path on the CPU); a string, for printing only."""
    try:
        import jax

        from ray_tpu.models import llama as J
        from ray_tpu.observability import xla as RX
        from ray_tpu.serve.llm import engine as JE

        jc = J.LlamaConfig.tiny(max_seq_len=256, attn_impl="xla")
        eng = JE.LLMEngine(J.init_params(jc, jax.random.key(0)), jc,
                           JE.EngineConfig(num_slots=1, max_seq_len=256,
                                           prefill_buckets=(128,)))
        eng.submit(JE.Request(prompt=list(range(1, 101)), max_tokens=2))
        eng.drain()
        RX.flush_captures()
        rows = [r for r in RX.program_registry().rows()
                if r["fn"] == "llm_engine_insert"]
        return f"{rows[-1]['flops']:.0f} flops" if rows else "no row"
    except Exception as e:  # noqa: BLE001 - printed, never gated
        return f"unavailable ({type(e).__name__}: {e})"


def test_sampled_wall_derives_mfu_mbu_and_roofline(monkeypatch):
    from ray_tpu_torch.observability.jit import tracked_jit

    monkeypatch.setenv("RAY_TPU_xla_wall_sample_every", "1")
    monkeypatch.setattr(PX, "_publish_row", lambda row: False)
    reg = PX.program_registry()
    n = 64
    f = tracked_jit(lambda a, b: a @ b, name="xla_sample_matmul_port",
                    trace_budget=0)
    x = torch.ones((n, n))
    f(x, x)
    f(x, x)
    row = [r for r in reg.rows() if r["fn"] == "xla_sample_matmul_port"][0]
    assert row["flops"] == 2 * n ** 3
    assert row["bytes_accessed"] == 3 * n * n * 4
    assert row["samples"] == 1 and row["wall_s"] > 0
    assert row["mfu"] == pytest.approx(row["flops"] / row["wall_s"] / 100e9)
    assert row["mbu"] == pytest.approx(
        row["bytes_accessed"] / row["wall_s"] / 100e9)
    ideal = max(row["flops"], row["bytes_accessed"]) / 100e9
    assert row["lost_roofline_s_per_call"] == pytest.approx(
        max(row["wall_s"] - ideal, 0.0))
    assert row["verdict"] in ("compute-bound", "memory-bound")


def test_sampling_off_keeps_every_call_unsampled(monkeypatch):
    from ray_tpu_torch.observability import jit as PJ

    monkeypatch.setenv("RAY_TPU_xla_wall_sample_every", "0")
    monkeypatch.setattr(PX, "_publish_row", lambda row: False)
    samples = []
    monkeypatch.setattr(PX, "on_tracked_sample",
                        lambda *a, **k: samples.append(a))
    f = PJ.tracked_jit(lambda a: a + 1, name="xla_unsampled_port",
                       trace_budget=0)
    for _ in range(10):
        f(torch.ones(4))
    assert samples == []
    row = [r for r in PX.program_registry().rows()
           if r["fn"] == "xla_unsampled_port"][0]
    assert row["samples"] == 0 and row["wall_s"] is None


# ------------------------------------------------------------ cluster tier

@pytest.fixture(scope="module")
def xla_cluster():
    import ray_tpu_torch

    os.environ["RAY_TPU_xla_programs_buffer_size"] = "32"
    os.environ["RAY_TPU_xla_wall_sample_every"] = "1"
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                              object_store_memory=128 * 1024 * 1024,
                              include_dashboard=True,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()
    os.environ.pop("RAY_TPU_xla_programs_buffer_size", None)
    os.environ.pop("RAY_TPU_xla_wall_sample_every", None)


def _gcs():
    from ray_tpu_torch._private.worker import global_worker

    return global_worker().gcs


def _get(url: str):
    with urllib.request.urlopen(url, timeout=15) as resp:
        return resp.status, resp.read()


def _xrow(**kw):
    row = {"fn": "synth_fn", "signature": "(float32[8,8])",
           "flops": 1e6, "bytes_accessed": 3e5, "transcendentals": 0.0,
           "arg_bytes": 2e5, "out_bytes": 1e5, "temp_bytes": 0.0,
           "alias_bytes": 0.0, "peak_hbm_bytes": 3e5,
           "compile_seconds": 0.2, "calls": 10, "samples": 2,
           "wall_s": 0.01, "achieved_flops_per_s": 1e8,
           "achieved_bytes_per_s": 3e7, "mfu": 0.001, "mbu": 0.0003,
           "exposed_comm_fraction": 0.0, "verdict": "compute-bound",
           "lost_roofline_s_per_call": 0.005,
           "lost_roofline_s_total": 0.05, "spec": "cpu",
           "measurement": "cpu", "pid": 4242}
    row.update(kw)
    return row


def test_ring_list_and_summary(xla_cluster):
    from ray_tpu_torch.util import state

    gcs = _gcs()
    for i in range(3):
        gcs.call("report_xla_programs", row=_xrow(
            fn="synth_a", signature=f"(float32[{8 << i},8])",
            flops=1e6 * (i + 1)))
    gcs.call("report_xla_programs", row=_xrow(
        fn="synth_b", verdict="memory-bound",
        node_id=b"\x5b\x7e\xc0\x14"))
    gcs.call("report_xla_programs", row=_xrow(
        fn="synth_hog", flops=1e9, calls=100,
        lost_roofline_s_total=9.0))

    rows = state.list_xla_programs(fn="synth_a")
    assert len(rows) == 3 and all(r["fn"] == "synth_a" for r in rows)
    assert rows[-1]["signature"] == "(float32[32,8])"   # newest-last
    assert len(state.list_xla_programs(fn="synth_a", limit=2)) == 2
    only = state.list_xla_programs(verdict="memory-bound")
    assert only and all(r["verdict"] == "memory-bound" for r in only)
    # Raw-bytes node ids land as hex: these rows feed JSON surfaces.
    assert only[-1]["node_id"] == "5b7ec014"

    summary = state.xla_summary()
    assert summary["programs"] >= 5
    assert summary["rows_recorded"] >= 5
    assert summary["top_by_flops"][0]["fn"] == "synth_hog"
    assert summary["top_by_headroom"][0]["fn"] == "synth_hog"
    assert summary["verdicts"]["compute-bound"] >= 4
    assert summary["verdicts"]["memory-bound"] >= 1
    assert summary["measurements"]["cpu"] >= 5
    assert summary["total_flops"] >= 1e9 * 100
    assert summary["total_peak_hbm_bytes"] >= 5 * 3e5
    assert summary["lost_roofline_s_total"] >= 9.0


def test_ring_is_bounded(xla_cluster):
    from ray_tpu_torch.util import state

    gcs = _gcs()
    before = state.xla_summary()["rows_recorded"]
    for i in range(100):
        gcs.call("report_xla_programs",
                 row=_xrow(fn="bulk", signature=f"(s{i})"))
    summary = state.xla_summary()
    assert summary["rows_recorded"] == before + 100
    assert summary["rows_in_buffer"] <= 32
    assert summary["programs"] <= 32


def test_malformed_row_dropped_not_fatal(xla_cluster):
    from ray_tpu_torch.util import state

    gcs = _gcs()
    before = state.xla_summary()["rows_recorded"]
    assert gcs.call("report_xla_programs", row={"fn": "evil"})
    assert gcs.call("report_xla_programs",
                    row=_xrow(fn="evil2", flops="bogus"))
    assert state.xla_summary()["rows_recorded"] == before
    gcs.call("report_xla_programs", row=_xrow(fn="after"))
    assert state.xla_summary()["rows_recorded"] == before + 1


def test_cpu_rows_with_no_peak_bytes_ingest(xla_cluster):
    """A CPU row's ``temp_bytes``/``peak_hbm_bytes`` are None: the ring
    keeps them None and the summary's byte total skips them."""
    from ray_tpu_torch.util import state

    _gcs().call("report_xla_programs", row=_xrow(
        fn="cpu_none", temp_bytes=None, peak_hbm_bytes=None))
    row = state.list_xla_programs(fn="cpu_none")[-1]
    assert row["temp_bytes"] is None and row["peak_hbm_bytes"] is None
    assert state.xla_summary()["programs"] >= 1


def test_engine_bucket_programs_attributed(xla_cluster):
    """A real tiny engine's programs all land in the fleet summary with
    nonzero FLOPs and bytes and, once sampled, MFU/MBU and a verdict,
    every row CPU-tagged here."""
    from ray_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_tpu_torch.serve.llm.engine import (EngineConfig, LLMEngine,
                                                Request)
    from ray_tpu_torch.util import state

    config = LlamaConfig.tiny()
    params = init_params(config, device="cpu")
    engine = LLMEngine(params, config, EngineConfig(
        num_slots=2, max_seq_len=32, prefill_buckets=(8,)), device="cpu")
    rng = np.random.RandomState(3)

    def _wave():
        for _ in range(3):
            engine.submit(Request(
                prompt=rng.randint(0, config.vocab_size, 5).tolist(),
                max_tokens=4))
        engine.drain()

    _wave()
    _wave()
    for fn in ("llm_engine_tick", "llm_engine_insert"):
        rows = state.list_xla_programs(fn=fn)
        assert rows, f"no program rows for {fn}"
        for r in rows:
            assert r["flops"] > 0
            assert r["bytes_accessed"] > 0
            assert r["measurement"] == "cpu" and r["spec"] == "cpu"
        last = rows[-1]
        assert last["samples"] > 0 and last["wall_s"] > 0
        assert last["mfu"] > 0 and last["mbu"] > 0
        assert last["verdict"] in ("compute-bound", "memory-bound",
                                   "comm-bound")


def test_shape_drift_emits_one_perf_regression(xla_cluster):
    """A new program whose FLOPs drift past xla_regression_ratio emits
    exactly ONE typed PERF_REGRESSION naming the program and the drifted
    dimension (the k=2 -> k=8 loop quadruples FLOPs)."""
    from ray_tpu_torch.observability.jit import tracked_jit
    from ray_tpu_torch.util import state

    def body(a, k):
        for _ in range(k):
            a = a @ a
        return a

    f = tracked_jit(body, name="drift_probe", static_argnums=(1,),
                    trace_budget=0)
    x = torch.ones((64, 64))
    f(x, 2)
    f(x, 8)

    def _events():
        return [e for e in
                state.list_cluster_events(event_type="PERF_REGRESSION")
                if e.get("fn") == "drift_probe"]

    events = _events()
    assert len(events) == 1
    ev = events[0]
    assert ev["severity"] == "WARNING"
    assert ev["dimension"] == "flops"
    assert ev["ratio"] == pytest.approx(4.0)
    assert "drift_probe" in ev["message"] and "flops" in ev["message"]
    assert ev["measurement"] == "cpu"
    f(x, 16)
    assert len(_events()) == 1


def test_api_programs_contract(xla_cluster):
    from ray_tpu_torch import _local_node

    _gcs().call("report_xla_programs", row=_xrow(fn="dash_fn"))
    base = _local_node.dashboard_url

    status, body = _get(base + "/api/programs")
    assert status == 200
    payload = json.loads(body)
    assert set(payload) == {"summary", "programs", "metrics"}
    assert payload["summary"]["programs"] >= 1
    assert payload["programs"]

    status, body = _get(base + "/api/programs?fn=dash_fn&limit=1")
    payload = json.loads(body)
    assert len(payload["programs"]) == 1
    assert payload["programs"][0]["fn"] == "dash_fn"

    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(base + "/api/programs?limit=bogus")
    assert ei.value.code == 400


def test_xla_metrics_exported(xla_cluster):
    from ray_tpu_torch.observability.jit import tracked_jit
    from ray_tpu_torch.util import metrics

    f = tracked_jit(lambda a, b: a @ b, name="xla_metric_probe",
                    trace_budget=0)
    x = torch.ones((16, 16))
    f(x, x)
    f(x, x)
    assert metrics.flush()
    text = _gcs().call("metrics_text")
    assert "rtpu_xla_program_flops" in text
    assert 'fn="xla_metric_probe"' in text
    assert "rtpu_xla_program_mfu" in text
    assert "rtpu_xla_program_mbu" in text
    assert "rtpu_xla_program_wall_seconds_bucket" in text
    assert not math.isnan(PX.program_registry().rows()[-1]["flops"])
