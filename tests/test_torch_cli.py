"""The port's command line (``python -m ray_tpu_torch``,
``ray_tpu_torch/scripts/cli.py``): the reference's
``tests/test_ops_plane.py::test_cli_start_status_stop`` on a port cluster;
``up`` and ``down`` of a cluster YAML whose head has no GPU, where a
``num_gpus=1`` task makes the autoscaler launch a node of (faked) cards,
lands there, and the idle node goes, and ``down`` leaves no process of the
session; and ``stop``'s pattern, which matches the port's daemons and
none of the JAX package's, as the reference's matches none of the port's.

No test runs ``stop`` itself: it would end every port cluster on the host.
Each test kills only its own session's processes, and every wait has a
timeout.
"""

import inspect
import os
import re
import subprocess
import sys
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.accelerators import gpu as G
from ray_tpu_torch.scripts import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    for var in (G.FAKE_GPUS_ENV, G.FAKE_GPU_TYPE_ENV, "RAY_TPU_ADDRESS"):
        env.pop(var, None)
    env.update(extra)
    return env


def _cli(*args, env, timeout=120):
    return subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


def _session_pids(session_dir):
    out = subprocess.run(["pgrep", "-f", session_dir], capture_output=True,
                         text=True, timeout=30)
    return {int(p) for p in out.stdout.split()} - {os.getpid()}


def _wait_gone(session_dir, timeout=30.0):
    deadline = time.monotonic() + timeout
    while True:
        left = _session_pids(session_dir)
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.2)


def test_help_lists_the_cluster_commands():
    out = _cli("--help", env=_env(), timeout=60)
    assert out.returncode == 0, out.stderr
    for word in ("start", "stop", "up", "down", "attach", "status"):
        assert re.search(rf"\b{word}\b", out.stdout), word
    start = _cli("start", "--help", env=_env(), timeout=60)
    assert "--num-gpus" in start.stdout and "--num-tpus" not in start.stdout


@pytest.mark.timeout(150)
def test_cli_start_status_list_and_scoped_kill():
    """Full CLI lifecycle in a subprocess-started standalone cluster."""
    env = _env()
    out = _cli("start", "--head", "--num-cpus", "2", "--num-gpus", "0",
               env=env)
    assert "cluster address:" in out.stdout, out.stderr
    addr = out.stdout.split("cluster address:")[1].split()[0]
    session_dir = out.stdout.split("session dir:")[1].split()[0]
    try:
        assert os.path.join("ray_tpu_torch", "session_") in session_dir
        st = _cli("--address", addr, "status", env=env)
        assert "nodes: 1 alive" in st.stdout, st.stderr
        assert " CPU" in st.stdout and " GPU" not in st.stdout
        ls = _cli("--address", addr, "list", "nodes", env=env)
        assert "NodeID" in ls.stdout or "node" in ls.stdout.lower()
        js = _cli("--address", addr, "list", "nodes", "--json", env=env)
        assert js.returncode == 0, js.stderr
        assert '"Alive": true' in js.stdout
        assert _session_pids(session_dir)
    finally:
        # Selective stop: only THIS cluster's daemons (a global `stop`
        # would end the other test modules' clusters).
        subprocess.run(["pkill", "-f", session_dir],
                       capture_output=True, timeout=60)
    assert not _wait_gone(session_dir)


YAML = """
cluster_name: {name}
max_workers: 2
provider:
  type: subprocess
available_node_types:
  cpu.head:
    resources: {{CPU: 2}}
  gpu.h100:
    node_config: {{gpu: H100-1, cpus_per_host: 2}}
    min_workers: 0
    max_workers: 1
head_node_type: cpu.head
idle_timeout_minutes: 0.05
"""


def _lines(proc, sink):
    for line in proc.stdout:
        sink.append(line)


@pytest.mark.timeout(170)
def test_up_autoscales_a_gpu_node_and_down_leaves_nothing(tmp_path):
    name = f"cli-{os.getpid()}"
    cfg = tmp_path / "cluster.yaml"
    cfg.write_text(YAML.format(name=name))
    # The faked cards are the node's; the head type has no GPU, and the
    # launcher's state file goes under this test's TMPDIR.
    env = _env(**{G.FAKE_GPUS_ENV: "1", G.FAKE_GPU_TYPE_ENV: "H100",
                  "TMPDIR": str(tmp_path)})
    up = subprocess.Popen([sys.executable, "-m", "ray_tpu_torch", "up",
                           str(cfg)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, env=env)
    lines, session_dir = [], None
    reader = threading.Thread(target=_lines, args=(up, lines), daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + 90
        while not any("session dir:" in ln for ln in lines):
            assert up.poll() is None and time.monotonic() < deadline, lines
            time.sleep(0.1)
        text = "".join(lines)
        addr = text.split("address:")[1].split()[0]
        session_dir = text.split("session dir:")[1].split()[0]
        state = tmp_path / f"ray_tpu_torch-cluster-{name}.json"
        assert state.exists()
        att = _cli("attach", str(cfg), "--print-address", env=env)
        assert att.stdout.strip() == addr, att.stderr

        ray_tpu_torch.init(address=addr)
        try:
            assert "GPU" not in ray_tpu_torch.cluster_resources()

            @ray_tpu_torch.remote(num_gpus=1)
            def on_the_card():
                return (ray_tpu_torch.get_runtime_context().get_node_id(),
                        os.environ.get("CUDA_VISIBLE_DEVICES"))

            node_id, visible = ray_tpu_torch.get(on_the_card.remote(),
                                                 timeout=90)
            assert visible == "0"
            node = next(n for n in ray_tpu_torch.nodes()
                        if n["NodeID"] == node_id)
            assert node["Labels"]["autoscaler-node-type"] == "gpu.h100"
            assert node["Resources"]["GPU"] == 1
            assert node["Resources"]["GPU-H100"] == 1
            # Idle past 3 s: the monitor retires the node.
            deadline = time.monotonic() + 60
            while "GPU" in ray_tpu_torch.cluster_resources():
                assert time.monotonic() < deadline, \
                    "the idle GPU node was never terminated"
                time.sleep(0.5)
            assert any("autoscaler: launched 1" in ln for ln in lines)
            assert any("terminated 1" in ln for ln in lines)
        finally:
            ray_tpu_torch.shutdown()
        down = _cli("down", str(cfg), env=env)
        assert down.returncode == 0, down.stderr
        assert "shutting down" in down.stdout
        assert up.wait(timeout=60) == 0, "".join(lines)
        assert not state.exists()
        assert not _wait_gone(session_dir, 15)
    finally:
        if up.poll() is None:
            up.kill()
            up.wait(timeout=30)
        if session_dir:
            subprocess.run(["pkill", "-9", "-f", session_dir],
                           capture_output=True, timeout=60)


REF_STOP_PATTERN = "ray_tpu._private.(gcs_server|raylet|worker_main)"
DAEMONS = ("gcs_server", "raylet", "worker_main")


def test_stop_pattern_tells_the_packages_apart(tmp_path):
    """``pkill -f``'s pattern as each package's ``stop`` gives it, against
    sleeping processes whose command lines are the daemons' of each
    package: the port's matches only the port's, the reference's only its
    own."""
    from ray_tpu.scripts import cli as ref_cli

    assert f'"{REF_STOP_PATTERN}"' in inspect.getsource(ref_cli.cmd_stop)
    assert "STOP_PATTERN" in inspect.getsource(cli.cmd_stop)
    tag = f"--session-dir {tmp_path}/stop-probe"
    procs = {}
    try:
        for pkg in ("ray_tpu", "ray_tpu_torch"):
            for daemon in DAEMONS:
                procs[pkg, daemon] = subprocess.Popen(
                    [sys.executable, "-c", "import time; time.sleep(120)",
                     "-m", f"{pkg}._private.{daemon}", *tag.split()])
        by_pid = {p.pid: key for key, p in procs.items()}

        def matched(pattern):
            out = subprocess.run(["pgrep", "-f", pattern],
                                 capture_output=True, text=True, timeout=30)
            return {by_pid[int(p)] for p in out.stdout.split()
                    if int(p) in by_pid}

        deadline = time.monotonic() + 30
        while len(matched(str(tmp_path))) < len(procs):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert matched(cli.STOP_PATTERN) == {("ray_tpu_torch", d)
                                             for d in DAEMONS}
        assert matched(REF_STOP_PATTERN) == {("ray_tpu", d) for d in DAEMONS}
    finally:
        for p in procs.values():
            p.kill()
            p.wait(timeout=30)
