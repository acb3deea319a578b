"""The dashboard head on the port's runtime (``ray_tpu_torch.dashboard``):
the cases of the reference's own ``tests/test_dashboard.py``, the log
retrieval cases of ``tests/test_failure_forensics.py`` and the stack and
profile cases of ``tests/test_profiling.py``, each asserting what it
asserts there, against a port cluster started with
``include_dashboard=True``; and the Grafana dashboard held to the JAX
package's, panel for panel, with its accelerator panel over ``GPU``. One
cluster for the module; every wait has a timeout.
"""

import json
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def dash_cluster():
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                              object_store_memory=128 * 1024 * 1024,
                              include_dashboard=True,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


def _get(url: str):
    with urllib.request.urlopen(url, timeout=15) as resp:
        body = resp.read()
        return resp.status, resp.headers.get_content_type(), body


def _dashboard_url() -> str:
    from ray_tpu_torch import _local_node

    assert _local_node is not None and _local_node.dashboard_url
    return _local_node.dashboard_url


def test_dashboard_endpoints(dash_cluster):
    # Some cluster activity to observe.
    @ray_tpu_torch.remote
    class Pinger:
        def ping(self):
            return "pong"

    actor = Pinger.options(name="dash_pinger").remote()
    assert ray_tpu_torch.get(actor.ping.remote(), timeout=60) == "pong"

    base = _dashboard_url()
    assert dash_cluster["dashboard_url"] == base

    status, ctype, body = _get(base + "/")
    assert status == 200 and ctype == "text/html"
    assert b"ray_tpu_torch dashboard" in body
    # SPA client markers: hash routes + the views the reference app has.
    for marker in (b"#/overview", b"#/nodes", b"#/actors", b"#/jobs",
                   b"#/submissions", b"#/tasks", b"hashchange"):
        assert marker in body, marker

    status, _, body = _get(base + "/api/cluster")
    cluster = json.loads(body)
    assert cluster["total"].get("CPU") == 4.0

    status, _, body = _get(base + "/api/nodes")
    nodes = json.loads(body)
    assert len(nodes) == 1 and nodes[0]["state"] == "ALIVE"
    assert nodes[0]["workers"] >= 1

    status, _, body = _get(base + "/api/actors")
    actors = json.loads(body)
    assert any(a["class"].endswith("Pinger") for a in actors), actors

    status, _, body = _get(base + "/api/jobs")
    assert json.loads(body), "driver job missing"

    status, ctype, body = _get(base + "/metrics")
    assert ctype == "text/plain"

    ray_tpu_torch.kill(actor)


def test_dashboard_timeline_and_serve_endpoints(dash_cluster):
    """GET /api/timeline downloads valid Chrome-trace JSON of the ring
    buffer; GET /api/serve summarizes serving/JIT telemetry."""
    from ray_tpu_torch.util import metrics, tracing

    @ray_tpu_torch.remote
    def traced():
        with tracing.span("dash-span"):
            time.sleep(0.01)
        return 1

    assert ray_tpu_torch.get(traced.options(name="dash_traced").remote(),
                             timeout=60) == 1
    # Serving-plane metrics from the driver (engine-shaped names).
    metrics.Counter("jit_dash_probe_total").inc(1.0)
    assert metrics.flush()
    from ray_tpu_torch._private.worker import global_worker
    global_worker().flush_task_events()

    base = _dashboard_url()
    deadline = time.monotonic() + 15
    trace = []
    while time.monotonic() < deadline:
        with urllib.request.urlopen(base + "/api/timeline",
                                    timeout=15) as resp:
            assert resp.status == 200
            disp = resp.headers.get("Content-Disposition", "")
            trace = json.loads(resp.read())
        if any(e["name"] == "dash_traced" for e in trace):
            break
        time.sleep(0.5)
    assert "timeline.json" in disp
    names = {e["name"] for e in trace}
    assert "dash_traced" in names, names
    assert all({"name", "cat", "ph", "ts"} <= set(e) for e in trace)

    status, _, body = _get(base + "/api/serve")
    assert status == 200
    summary = json.loads(body)
    assert summary.get("jit_dash_probe_total", {}).get("type") == "counter"


def test_dashboard_url_registered_in_kv(dash_cluster):
    from ray_tpu_torch._private.worker import global_worker

    w = global_worker()
    url = w.gcs.call("kv_get", namespace="dashboard", key="dashboard_url",
                     timeout=10)
    assert url is not None
    assert url.decode().startswith("http://")
    assert url.decode() == _dashboard_url()


def test_grafana_dashboard_factory(tmp_path):
    """Generated dashboard JSON is well-formed and its exprs reference
    series the GCS actually exports (reference:
    grafana_dashboard_factory.py)."""
    from ray_tpu_torch.dashboard.grafana import (
        generate_default_dashboard, write_dashboard)

    dash = generate_default_dashboard(extra_metric_names=["my_metric"])
    assert dash["uid"] == "ray-tpu-default"
    titles = [p["title"] for p in dash["panels"]]
    assert "Alive nodes" in titles and "my_metric" in titles
    assert "GPU available vs total" in titles
    assert not [t for t in titles if "TPU" in t]
    for p in dash["panels"]:
        # Quantile/rate panels wrap the series in PromQL functions, so
        # "contains an rtpu_ series" is the invariant, not a prefix.
        assert "rtpu_" in p["targets"][0]["expr"]
        assert {"h", "w", "x", "y"} <= set(p["gridPos"])

    path = write_dashboard(str(tmp_path / "dash.json"))
    assert json.load(open(path))["panels"]


@pytest.mark.parametrize("extra", [None, ["my_metric", "serve_x_total"]])
def test_grafana_dashboard_matches_reference(extra):
    """The same dashboard JSON as the JAX package's, but for the one
    accelerator panel, which reads the ``GPU`` resource where the
    reference's reads ``TPU``."""
    from ray_tpu.dashboard.grafana import \
        generate_default_dashboard as reference

    from ray_tpu_torch.dashboard.grafana import generate_default_dashboard

    want = json.dumps(reference(extra_metric_names=extra), sort_keys=True)
    got = json.dumps(generate_default_dashboard(extra_metric_names=extra),
                     sort_keys=True)
    assert got != want
    assert got == want.replace("TPU available vs total",
                               "GPU available vs total").replace(
        'resource=\\"TPU\\"', 'resource=\\"GPU\\"')


def test_node_reporter_metrics(dash_cluster):
    """Per-node reporter gauges reach the Prometheus endpoint
    (reference: reporter_agent.py -> MetricsAgent)."""
    from ray_tpu_torch._private.worker import global_worker

    w = global_worker()
    deadline = time.monotonic() + 30
    text = ""
    while time.monotonic() < deadline:
        text = w.gcs.call("metrics_text", timeout=10)
        if "rtpu_node_cpu_percent" in text:
            break
        time.sleep(0.5)
    assert "rtpu_node_cpu_percent" in text
    assert "rtpu_node_mem_used_bytes" in text
    assert "rtpu_node_workers" in text
    assert 'rtpu_node_disk_bytes{node="' in text


def test_profile_and_stack_endpoints(dash_cluster):
    """On-demand worker profiling through the dashboard: folded-stack
    CPU profile + all-thread stack dump (reference: profile_manager.py)."""
    @ray_tpu_torch.remote
    def spin(sec):
        t = time.monotonic()
        n = 0
        while time.monotonic() - t < sec:
            n += 1
        return n

    ref = spin.remote(12.0)
    base = _dashboard_url()
    deadline = time.monotonic() + 30
    folded = ""
    while time.monotonic() < deadline and "spin" not in folded:
        with urllib.request.urlopen(
                f"{base}/api/profile?duration=1.0", timeout=60) as resp:
            prof = json.loads(resp.read())
        folded = "\n".join(v.get("folded", "") for v in prof.values()
                           if isinstance(v, dict))
    assert "spin" in folded  # the busy frame dominates the samples
    with urllib.request.urlopen(
            f"{base}/api/profile/stacks", timeout=60) as resp:
        stacks = json.loads(resp.read())
    assert any("MainThread" in (v.get("stacks", "") or "")
               or v.get("stacks") for v in stacks.values()
               if isinstance(v, dict))
    assert ray_tpu_torch.get(ref, timeout=60) > 0


# -------------------------------------- failure forensics: log retrieval


def test_get_log_by_task_returns_only_that_task(dash_cluster):
    from ray_tpu_torch.util import state

    @ray_tpu_torch.remote
    def chatty(tag):
        print(f"chatty says {tag}", flush=True)
        return tag

    ref_a = chatty.remote("alpha")
    ref_b = chatty.remote("beta")
    assert ray_tpu_torch.get([ref_a, ref_b], timeout=60) == ["alpha", "beta"]

    tid_a = ref_a.task_id().hex()
    deadline = time.monotonic() + 20
    lines = []
    while time.monotonic() < deadline:
        lines = state.get_log(task_id=tid_a, tail=50)
        if lines:
            break
        time.sleep(0.25)
    assert any("chatty says alpha" in ln for ln in lines), lines
    assert not any("beta" in ln for ln in lines), (
        f"get_log(task_id=) leaked another task's lines: {lines}")

    base = _dashboard_url()
    body = json.loads(urllib.request.urlopen(
        base + f"/api/logs?task_id={tid_a}&tail=50", timeout=15).read())
    assert any("chatty says alpha" in ln for ln in body["lines"])
    assert not any("beta" in ln for ln in body["lines"])

    # Selector validation: zero selectors is an error on both surfaces.
    with pytest.raises(ValueError):
        state.get_log(tail=5)
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(base + "/api/logs?tail=5", timeout=15)


def test_get_log_by_actor(dash_cluster):
    from ray_tpu_torch.util import state

    @ray_tpu_torch.remote
    class Talker:
        def say(self, what):
            print(f"talker: {what}", flush=True)
            return what

    t = Talker.remote()
    assert ray_tpu_torch.get(t.say.remote("hello-logs"), timeout=60) \
        == "hello-logs"
    aid = None
    for a in state.list_actors():
        if a["class_name"] == "Talker" and a["state"] == "ALIVE":
            aid = a["actor_id"]
    assert aid
    deadline = time.monotonic() + 20
    lines = []
    while time.monotonic() < deadline:
        lines = state.get_log(actor_id=aid, tail=50)
        if any("talker: hello-logs" in ln for ln in lines):
            break
        time.sleep(0.25)
    assert any("talker: hello-logs" in ln for ln in lines), lines


# ------------------------------------------------ profiling: state views


@ray_tpu_torch.remote
class _Spinner:
    def ping(self):
        return "pong"

    def spin_marker_method(self, seconds):
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            pass
        return "spun"


def test_state_stack_covers_workers(dash_cluster):
    """util.state.stack() returns live all-thread stacks for every
    worker on the node, and the actor selector narrows to one."""
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.util import state

    a = _Spinner.remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "pong"

    def alive(pid):
        try:
            with open(f"/proc/{pid}/stat") as f:
                return f.read().rsplit(")", 1)[1].split()[0] != "Z"
        except OSError:
            return False

    # The GCS keeps the rows of workers that have exited (this module's
    # earlier cases killed actors): the sweep covers the live ones.
    rows = global_worker().gcs.call("list_workers", timeout=30)
    pids = {r["worker_id"].hex(): r["pid"] for r in rows
            if r.get("mode") == "worker" and alive(r["pid"])}
    worker_ids = set(pids)
    assert worker_ids

    out = state.stack()
    assert worker_ids <= set(out), (worker_ids, set(out))
    # A pooled worker the raylet retires while idle can exit between the
    # listing and its dump: every worker alive before and after the sweep
    # is held to the reference's assertions.
    worker_ids = {w for w in worker_ids if alive(pids[w])}
    assert worker_ids
    for whex in worker_ids:
        entry = out[whex]
        assert entry["pid"] > 0, entry
        assert "--- thread MainThread" in entry["stacks"]
        names = {t["thread_name"] for t in entry["threads"]}
        assert "MainThread" in names

    narrowed = state.stack(actor_id=a._actor_id.hex())
    assert len(narrowed) == 1
    (whex,) = narrowed
    assert whex in worker_ids

    with pytest.raises(ValueError):
        state.stack(node_id="ab", worker_id="cd")


def test_state_profile_attributes_busy_actor(dash_cluster):
    """util.state.profile(actor_id=..., duration=1) returns a non-empty
    collapsed-stack + speedscope payload attributing the busy method."""
    from ray_tpu_torch.util import state

    a = _Spinner.remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "pong"
    ref = a.spin_marker_method.remote(3.0)

    out = state.profile(actor_id=a._actor_id.hex(), duration=1.0, hz=200)
    assert out["partial"] is False
    assert out["exit"] is None
    assert out["samples"] > 0
    assert out["pid"] > 0
    assert "spin_marker_method" in out["folded"]
    sco = out["speedscope"]
    assert sco["profiles"], sco
    assert any("spin_marker_method" in f["name"]
               for f in sco["shared"]["frames"])
    assert ray_tpu_torch.get(ref, timeout=60) == "spun"

    with pytest.raises(ValueError):
        state.profile()  # needs exactly one selector
