"""Jobs and the state views on the port's runtime
(``ray_tpu_torch.job_submission``, ``ray_tpu_torch.util.state``): the job
and state cases of the reference's own ``tests/test_ops_plane.py``, each
asserting what it asserts there, against the port's cluster; the job
supervisor's status records held to the JAX package's on the same
entrypoints; a driver that dies or a job that is stopped ending what its
driver owned (its GPU actors and its placement groups' bundles back in
the cluster, whole and fractional), while Serve replicas that a driver
deployed outlive it; and the slice as a whole:
a job submitted over HTTP with a ``working_dir`` and ``env_vars`` serves
from a ``num_gpus=1`` actor (the GPU faked, the server on the CPU) the
JAX package's greedy tokens on the same weights. One cluster for the
module, with the dashboard; every wait has a timeout.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.util import state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(num_cpus=8, num_gpus=1,
                              object_store_memory=128 * 1024 * 1024,
                              include_dashboard=True,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


def _wait_for(pred, timeout=30.0, period=0.2):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(period)
    return False


def test_state_summary_and_lists(cluster):
    @ray_tpu_torch.remote
    class Pinger:
        def ping(self):
            return "pong"

    actor = Pinger.remote()
    ray_tpu_torch.get(actor.ping.remote(), timeout=60)

    s = state.summary()
    assert s["nodes_alive"] >= 1
    assert s["cluster_resources"]["CPU"] >= 1

    actors = state.list_actors()
    assert any(a["class_name"] == "Pinger" and a["state"] == "ALIVE"
               for a in actors)
    assert len(state.list_workers()) >= 1
    assert len(state.list_nodes()) >= 1
    ray_tpu_torch.kill(actor)


def test_task_events_reach_state_api(cluster):
    @ray_tpu_torch.remote
    def traced(x):
        return x + 1

    assert ray_tpu_torch.get(traced.remote(1), timeout=60) == 2
    from ray_tpu_torch._private.worker import global_worker

    global_worker().flush_task_events()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        tasks = state.list_tasks()
        finished = [t for t in tasks
                    if t["name"] == "traced" and t["state"] == "FINISHED"]
        if finished:
            break
        time.sleep(0.5)
    assert finished, f"no FINISHED traced task in {tasks}"


def test_prometheus_metrics_rpc_and_http(cluster):
    from ray_tpu_torch._private.worker import global_worker

    w = global_worker()
    text = w.gcs.call("metrics_text", timeout=30)
    assert "rtpu_nodes" in text
    assert 'rtpu_resource_capacity{' in text
    # Counter-suffix discipline: _total only on counters.
    assert "rtpu_nodes_total" not in text
    assert "rtpu_cluster_events_total" in text

    port_raw = w.gcs.call("kv_get", namespace="__internal__",
                          key="metrics_port")
    assert port_raw, "GCS did not start its metrics HTTP endpoint"
    port = int(port_raw.decode())
    body = urllib.request.urlopen(
        f"http://127.0.0.1:{port}/metrics", timeout=30).read().decode()
    assert "rtpu_nodes" in body


def test_job_submission_lifecycle(cluster, tmp_path):
    from ray_tpu_torch.job_submission import JobSubmissionClient

    script = tmp_path / "driver.py"
    script.write_text(
        "import os\n"
        "import ray_tpu_torch\n"
        "ray_tpu_torch.init(address=os.environ['RAY_TPU_ADDRESS'])\n"
        "@ray_tpu_torch.remote\n"
        "def f(x): return 2 * x\n"
        "print('total:', sum(ray_tpu_torch.get([f.remote(i) for i in "
        "range(4)], timeout=60)))\n"
        "ray_tpu_torch.shutdown()\n")

    client = JobSubmissionClient()
    sid = client.submit_job(entrypoint=f"{sys.executable} {script}")
    status = client.wait_until_finished(sid, timeout=180)
    assert status == "SUCCEEDED", client.get_job_logs(sid)
    assert "total: 12" in client.get_job_logs(sid)
    assert any(j["submission_id"] == sid for j in client.list_jobs())


def test_stop_job_kills_entrypoint_tree(cluster, tmp_path):
    """stop_job must terminate the entrypoint via the SUPERVISOR (which
    owns the child and its process group) — not a client-side os.kill,
    which only ever worked when client and supervisor shared a node."""
    from ray_tpu_torch.job_submission import JobSubmissionClient

    pid_path = tmp_path / "child.pid"
    script = tmp_path / "spin.py"
    script.write_text(
        "import os, subprocess, sys, time\n"
        # A grandchild too: the process-group kill must reap the tree.
        "sub = subprocess.Popen([sys.executable, '-c',"
        " 'import time; time.sleep(600)'])\n"
        f"open({str(pid_path)!r}, 'w').write("
        "f'{os.getpid()} {sub.pid}')\n"
        "time.sleep(600)\n")

    client = JobSubmissionClient()
    sid = client.submit_job(entrypoint=f"{sys.executable} {script}")
    deadline = time.monotonic() + 60
    while not pid_path.exists() and time.monotonic() < deadline:
        time.sleep(0.1)
    assert pid_path.exists(), client.get_job_logs(sid)
    child_pid, grandchild_pid = map(int, pid_path.read_text().split())

    assert client.stop_job(sid) is True
    assert client.get_job_status(sid) == "STOPPED"

    def _dead(pid):
        end = time.monotonic() + 15
        while time.monotonic() < end:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                return True
            time.sleep(0.1)
        return False

    assert _dead(child_pid), "entrypoint survived stop_job"
    assert _dead(grandchild_pid), "entrypoint's subprocess survived stop_job"


def test_failed_job_reports_failure(cluster):
    from ray_tpu_torch.job_submission import JobSubmissionClient

    client = JobSubmissionClient()
    sid = client.submit_job(entrypoint=f"{sys.executable} -c 'import sys; "
                                       f"print(\"dying\"); sys.exit(3)'")
    assert client.wait_until_finished(sid, timeout=120) == "FAILED"
    info = client.get_job_info(sid)
    assert info["returncode"] == 3
    assert "dying" in client.get_job_logs(sid)


def test_summary_rollups(cluster):
    """ray summary tasks/actors equivalents (reference:
    `util/state/summary.py`)."""
    @ray_tpu_torch.remote
    def summed(x):
        return x

    assert ray_tpu_torch.get([summed.remote(i) for i in range(3)],
                             timeout=60) == [0, 1, 2]

    @ray_tpu_torch.remote
    class Summarized:
        def ping(self):
            return "ok"

    a = Summarized.remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "ok"
    from ray_tpu_torch._private.worker import global_worker

    global_worker().flush_task_events()
    deadline = time.monotonic() + 15
    rows = []
    while time.monotonic() < deadline:
        rows = state.summary_tasks()
        if any(r["name"] == "summed" and r.get("FINISHED", 0) >= 3
               for r in rows):
            break
        time.sleep(0.5)
    srow = next(r for r in rows if r["name"] == "summed")
    assert srow["FINISHED"] >= 3 and srow["total"] >= 3

    arows = state.summary_actors()
    assert any(r["class"] == "Summarized" and r.get("ALIVE", 0) >= 1
               for r in arows)
    ray_tpu_torch.kill(a)


def test_job_rest_api_over_http(cluster, tmp_path):
    """Off-cluster job submission through the dashboard head's REST API
    (reference: dashboard/modules/job/job_head.py): submit over HTTP,
    poll status, fetch logs, list, stop."""
    from ray_tpu_torch.job_submission import JobSubmissionClient

    job = tmp_path / "restjob.py"
    job.write_text("print('REST-JOB-RAN')\n")
    slow = tmp_path / "slowjob.py"
    slow.write_text("import time; time.sleep(600)\n")
    url = cluster["dashboard_url"]
    assert url, "no dashboard"
    client = JobSubmissionClient(address=url)
    sid = client.submit_job(entrypoint=sys.executable + f" {job}")
    status = client.wait_until_finished(sid, timeout=180)
    assert status == "SUCCEEDED", client.get_job_logs(sid)
    assert "REST-JOB-RAN" in client.get_job_logs(sid)
    assert any(j.get("submission_id") == sid for j in client.list_jobs())
    sid2 = client.submit_job(entrypoint=sys.executable + f" {slow}")
    deadline = time.monotonic() + 120
    while (client.get_job_status(sid2) == "PENDING"
           and time.monotonic() < deadline):
        time.sleep(0.3)
    assert client.stop_job(sid2)
    assert client.wait_until_finished(sid2, timeout=60) == "STOPPED"


# ----------------------------------------- parity with the JAX package


class _FakeGcs:
    """The GCS KV that ``JobSupervisor.run`` reads and writes, recording
    every status it writes."""

    def __init__(self):
        self.kv, self.statuses = {}, []

    def call(self, method, namespace=None, key=None, value=None, **_):
        if method == "kv_get":
            return self.kv.get(key)
        assert method == "kv_put", method
        self.kv[key] = value
        self.statuses.append(json.loads(value)["status"])
        return True


def _supervise(package, scenario, tmp_path, monkeypatch):
    """One scenario through ``package``'s supervisor class, alone: the
    statuses it writes, the final record's keys and status, and run()'s
    return code."""
    import importlib
    import types

    jobs = importlib.import_module(f"{package}.job_submission")
    worker_mod = importlib.import_module(f"{package}._private.worker")
    tmp_path.mkdir()
    gcs = _FakeGcs()
    fake = types.SimpleNamespace(gcs=gcs, session_dir=str(tmp_path))
    monkeypatch.setattr(worker_mod, "global_worker", lambda: fake)
    sid = f"job_{scenario}"
    gcs.kv[sid] = json.dumps({"submission_id": sid, "status": "PENDING",
                              "entrypoint": "x"}).encode()
    gcs.statuses.clear()
    sup = jobs.JobSupervisor._cls()
    # The reference's run() also takes the entrypoint's env and cwd; the
    # port's entrypoint takes both from the supervisor's runtime_env.
    extra = ({}, None) if package == "ray_tpu" else ()
    entry = {"succeeds": "echo hi", "fails": "echo bye; exit 3",
             "stopped_before_spawn": "echo never",
             "stopped_while_running": "sleep 60"}[scenario]
    if scenario == "stopped_before_spawn":
        assert sup.stop() is True
        rc = sup.run(sid, entry, "127.0.0.1:1", *extra)
    elif scenario == "stopped_while_running":
        out = {}
        t = threading.Thread(target=lambda: out.update(rc=sup.run(
            sid, entry, "127.0.0.1:1", *extra)))
        t.start()
        assert _wait_for(lambda: "RUNNING" in gcs.statuses, 30)
        # The client writes STOPPED first, then asks the supervisor.
        record = json.loads(gcs.kv[sid])
        record["status"] = "STOPPED"
        gcs.call("kv_put", key=sid, value=json.dumps(record).encode())
        assert sup.stop(grace_s=3.0) is True
        t.join(30)
        assert not t.is_alive()
        rc = out["rc"]
    else:
        rc = sup.run(sid, entry, "127.0.0.1:1", *extra)
    record = json.loads(gcs.kv[sid])
    log = ""
    if record.get("log_path"):
        with open(record["log_path"]) as f:
            log = f.read()
    return {"statuses": gcs.statuses, "keys": sorted(record),
            "status": record["status"], "returncode": record.get("returncode"),
            "rc": rc, "log": log}


@pytest.mark.parametrize("scenario", ["succeeds", "fails",
                                      "stopped_before_spawn",
                                      "stopped_while_running"])
def test_job_status_transitions_match_reference(scenario, tmp_path,
                                                monkeypatch):
    """The supervisor of each package runs the same entrypoint: the same
    status writes in the GCS KV, the same record fields and final status,
    the same return code and log."""
    want = _supervise("ray_tpu", scenario, tmp_path / "ref", monkeypatch)
    got = _supervise("ray_tpu_torch", scenario, tmp_path / "port",
                     monkeypatch)
    assert got == want
    final = {"succeeds": "SUCCEEDED", "fails": "FAILED",
             "stopped_before_spawn": "PENDING",
             "stopped_while_running": "STOPPED"}[scenario]
    assert got["status"] == final


# ------------------------------------------------ a driver's death


def test_dead_driver_ends_its_job(cluster, tmp_path):
    """A driver killed outright ends its job as shutdown() would: its GPU
    actor is killed and its placement group removed, and the GPU the
    bundle reserved returns to the cluster and can be leased again (the
    actor's own lease gives its share back when its process ends)."""
    script = tmp_path / "pg_driver.py"
    script.write_text(
        "import os, sys, time\n"
        "import ray_tpu_torch as rt\n"
        "from ray_tpu_torch.util.placement_group import placement_group\n"
        "from ray_tpu_torch.util.scheduling_strategies import "
        "PlacementGroupSchedulingStrategy\n"
        "rt.init(address=sys.argv[1])\n"
        "pg = placement_group([{'CPU': 1, 'GPU': 1}])\n"
        "rt.get(pg.ready(), timeout=60)\n"
        "@rt.remote(num_gpus=1, num_cpus=1)\n"
        "class Held:\n"
        "    def pid(self):\n"
        "        return os.getpid()\n"
        "a = Held.options(scheduling_strategy=PlacementGroupSchedulingStrategy("
        "pg, placement_group_bundle_index=0)).remote()\n"
        "print('READY', rt.get(a.pid.remote(), timeout=60), flush=True)\n"
        "time.sleep(600)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, str(script), cluster["gcs_address"]],
        stdout=subprocess.PIPE, text=True, env=env)
    try:
        line = proc.stdout.readline()
        assert line.startswith("READY"), line
        actor_pid = int(line.split()[1])
        assert ray_tpu_torch.available_resources().get("GPU", 0) == 0
        proc.send_signal(signal.SIGKILL)
        proc.wait(30)
        assert _wait_for(
            lambda: ray_tpu_torch.available_resources().get("GPU", 0) == 1,
            60), ray_tpu_torch.available_resources()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    with pytest.raises(ProcessLookupError):
        os.kill(actor_pid, 0)
    assert not [p for p in state.list_placement_groups()
                if p["state"] == "CREATED"]
    held = [a for a in state.list_actors() if a["class_name"] == "Held"]
    assert held and all(a["state"] == "DEAD" for a in held)
    assert any(e["message"].endswith("is gone")
               for e in state.list_cluster_events(event_type="JOB_FINISHED"))

    @ray_tpu_torch.remote(num_gpus=1)
    def lease():
        return ray_tpu_torch.get_gpu_ids()

    assert ray_tpu_torch.get(lease.remote(), timeout=60) == [0]


_HALVES_ENTRY = """import json, os, sys, time
import ray_tpu_torch as rt
from ray_tpu_torch.util.placement_group import placement_group
from ray_tpu_torch.util.scheduling_strategies import (
    PlacementGroupSchedulingStrategy)
rt.init(address=os.environ["RAY_TPU_ADDRESS"])
bundles, where = json.loads(sys.argv[1])
pg = placement_group(bundles)
rt.get(pg.ready(), timeout=60)
@rt.remote(num_gpus=0.5, num_cpus=1)
class Half:
    def ids(self):
        return rt.get_gpu_ids()
halves = [Half.options(scheduling_strategy=PlacementGroupSchedulingStrategy(
    pg, placement_group_bundle_index=i)).remote() for i in where]
print("READY", rt.get([h.ids.remote() for h in halves], timeout=60),
      flush=True)
time.sleep(600)
"""


@pytest.mark.parametrize("shape", [
    # A training gang's shape: one half-GPU bundle for each actor.
    ([{"CPU": 1, "GPU": 0.5}] * 2, [0, 1]),
    # Both halves in one whole-GPU bundle.
    ([{"CPU": 2, "GPU": 1}], [0, 0]),
], ids=["bundle_each", "one_bundle"])
def test_stopped_job_frees_its_fractional_gang(cluster, tmp_path, shape):
    """A stopped job whose two 0.5-GPU actors sit in a placement group
    gives the whole card back when the group goes while they exit: two
    ``num_gpus=1`` actors, one after the other, then start on chip 0, and
    after them a fractional task is granted chip 0 too."""
    from ray_tpu_torch.job_submission import JobSubmissionClient

    script = tmp_path / "halves.py"
    script.write_text(_HALVES_ENTRY)
    # A GPU task of an earlier case may still hold its lease, idle.
    assert _wait_for(
        lambda: ray_tpu_torch.available_resources().get("GPU", 0) == 1, 60)
    client = JobSubmissionClient()
    sid = client.submit_job(
        entrypoint=f"{sys.executable} {script} '{json.dumps(shape)}'")
    assert _wait_for(lambda: "READY" in client.get_job_logs(sid), 120), \
        client.get_job_logs(sid)
    assert ray_tpu_torch.available_resources().get("GPU", 0) == 0
    assert client.stop_job(sid)
    assert client.get_job_status(sid) == "STOPPED"
    assert _wait_for(
        lambda: ray_tpu_torch.available_resources().get("GPU", 0) == 1,
        60), ray_tpu_torch.available_resources()

    @ray_tpu_torch.remote(num_gpus=1)
    class Whole:
        def ids(self):
            return ray_tpu_torch.get_gpu_ids()

    for _ in range(2):
        whole = Whole.remote()
        assert ray_tpu_torch.get(whole.ids.remote(), timeout=60) == [0]
        ray_tpu_torch.kill(whole)

    @ray_tpu_torch.remote(num_gpus=0.5)
    def half():
        return ray_tpu_torch.get_gpu_ids()

    assert ray_tpu_torch.get(half.remote(), timeout=60) == [0]


_SERVE_DRIVER = """import json, os, sys
import ray_tpu_torch as rt
from ray_tpu_torch import serve
rt.init(address=sys.argv[1])
@serve.deployment(num_replicas=2)
class Pid:
    def __call__(self, _):
        return os.getpid()
handle = serve.run(Pid.bind(), name="outlives")
pids = {handle.remote(None).result(timeout=60) for _ in range(20)}
print("PIDS " + json.dumps(sorted(pids)), flush=True)
rt.shutdown()
"""


def test_serve_app_outlives_the_driver_that_deployed_it(cluster, tmp_path):
    """Driver A deploys an app and exits; its job ends, but the replicas
    are the detached controller's, not A's: driver B gets its answers
    from the same replica processes."""
    from ray_tpu_torch import serve

    script = tmp_path / "serve_driver.py"
    script.write_text(_SERVE_DRIVER)
    env = dict(os.environ, PYTHONPATH=ROOT)
    jobs_before = {j["job_id"] for j in state.list_jobs()}
    try:
        out = subprocess.run(
            [sys.executable, str(script), cluster["gcs_address"]],
            capture_output=True, text=True, env=env, timeout=180)
        assert out.returncode == 0, out.stderr[-3000:]
        (line,) = [ln for ln in out.stdout.splitlines()
                   if ln.startswith("PIDS ")]
        pids = set(json.loads(line[5:]))
        assert len(pids) == 2
        # A's job is over, and the GCS has released what A owned.
        assert _wait_for(lambda: [
            j for j in state.list_jobs()
            if j["job_id"] not in jobs_before and j["state"] == "FINISHED"],
            30)
        time.sleep(1.0)
        handle = serve.get_app_handle("outlives")
        got = {handle.remote(None).result(timeout=60) for _ in range(20)}
        assert got == pids
        for pid in pids:
            os.kill(pid, 0)
    finally:
        serve.shutdown()


# -------------------------------------------- the slice, on the CPU

_JOB_ENTRY = '''import json, os, sys
import numpy as np
import ray_tpu_torch as rt
import tinyjob

rt.init(address=os.environ["RAY_TPU_ADDRESS"])
flat = dict(np.load("weights.npz"))
server = tinyjob.TinyJobServer.remote(tinyjob.unflatten(flat))
with open("requests.json") as f:
    reqs = json.load(f)
out = [rt.get(server.serve.remote(r), timeout=120)["tokens"] for r in reqs]
lease = rt.get(server.lease.remote(), timeout=60)
print("TOKENS " + json.dumps(out))
print("LEASE " + json.dumps(lease))
print("DRIVER " + json.dumps({
    "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
    "job_env": os.environ.get("JOB_ENV"),
    "foreign": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "ray_tpu"))}))
rt.shutdown()
'''

_JOB_HELPER = '''import os
import ray_tpu_torch as rt


def unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


@rt.remote(num_gpus=1)
class TinyJobServer:
    def __init__(self, tree):
        import torch
        from ray_tpu_torch.models.convert import params_from_numpy
        from ray_tpu_torch.models.llama import LlamaConfig
        from ray_tpu_torch.serve.llm import LLMServer

        cfg = LlamaConfig.tiny(dtype=torch.float32, attn_impl="flash")
        params = params_from_numpy(tree, cfg, "cpu")
        self.server = LLMServer(
            model_config=cfg, params_loader=lambda: params,
            engine_config={"num_slots": 2, "max_seq_len": 160,
                           "prefill_buckets": (16, 128)},
            quantize="bf16", device="cpu")

    def serve(self, request):
        return self.server(request)

    def lease(self):
        return {"gpu_ids": rt.get_gpu_ids(),
                "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}
'''


def _flatten(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def test_http_job_serves_jax_generate_tokens(cluster, tmp_path):
    """The slice as a whole: a job submitted over HTTP with a working dir
    (the entrypoint, a helper module it imports, the JAX package's tiny
    weights and the prompts) and env_vars, whose ``num_gpus=1`` actor
    serves the JAX package's greedy tokens; its driver sees no card."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from ray_tpu.models import llama as J

    from ray_tpu_torch.job_submission import JobSubmissionClient

    jc = J.LlamaConfig.tiny(dtype=jnp.float32)
    jp = J.init_params(jc, jax.random.key(0))
    rng = np.random.RandomState(0)
    reqs = [{"prompt": rng.randint(0, 256, p).tolist(), "max_tokens": n}
            for p, n in ((3, 6), (40, 7))]
    wd = tmp_path / "job"
    wd.mkdir()
    (wd / "entry.py").write_text(_JOB_ENTRY)
    (wd / "tinyjob.py").write_text(_JOB_HELPER)
    (wd / "requests.json").write_text(json.dumps(reqs))
    np.savez(wd / "weights.npz",
             **_flatten(jax.tree_util.tree_map(np.asarray, jp)))

    client = JobSubmissionClient(cluster["dashboard_url"])
    sid = client.submit_job(
        entrypoint=f"{sys.executable} entry.py",
        runtime_env={"working_dir": str(wd),
                     "env_vars": {"JOB_ENV": "set",
                                  "CUDA_VISIBLE_DEVICES": "0"}})
    assert client.wait_until_finished(sid, timeout=180) == "SUCCEEDED", \
        client.get_job_logs(sid)
    info = client.get_job_info(sid)
    assert info["runtime_env"]["working_dir"].startswith("gcs://_rtpu_pkg_")
    lines = dict(ln.split(" ", 1) for ln in
                 client.get_job_logs(sid).splitlines()
                 if ln.split(" ", 1)[0] in ("TOKENS", "LEASE", "DRIVER"))
    got = json.loads(lines["TOKENS"])
    assert json.loads(lines["LEASE"]) == {"gpu_ids": [0],
                                          "cuda_visible_devices": "0"}
    assert json.loads(lines["DRIVER"]) == {"cuda_visible_devices": "",
                                           "job_env": "set", "foreign": []}
    for r, out in zip(reqs, got):
        want = np.asarray(J.generate(
            jp, jnp.asarray([r["prompt"]], jnp.int32), jc,
            max_new_tokens=r["max_tokens"]))[0].tolist()
        assert out == want
