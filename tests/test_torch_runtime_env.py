"""runtime_env on the port's runtime (``ray_tpu_torch.runtime_env``): the
cases of the reference's own ``tests/test_runtime_env.py``, each asserting
what it asserts there, against the port's cluster; the port's own rule
that an env's ``env_vars`` cannot make a card visible to a worker that
leases none; and the pure functions held to the JAX package's on the same
inputs (``validate_runtime_env``'s results and errors, the packaging's
URIs and zip bytes). One cluster for the module (its GPU faked, so that a
lease can name one); every ``get`` has a timeout.
"""

import os
import sys
import zipfile

import pytest

import ray_tpu_torch


CONTAINER_VAR = "RAY_TPU_CONTAINER_RUNTIME"
STANDIN_IMAGE = "rtpu-standin:latest"

# A stand-in for a container runtime (this host has none): it records its
# arguments, drops ``run ... <image>``, applies the ``-e`` flags to the
# environment as a container would, and execs the rest (the image's
# ``python3`` is this interpreter).
_STANDIN = """#!{python}
import json, os, sys
args = sys.argv[1:]
with open(os.environ["RTPU_STANDIN_LOG"], "a") as f:
    f.write(json.dumps(sys.argv) + "\\n")
assert args[0] == "run", args
image = args.index({image!r})
env = dict(os.environ)
i = 1
while i < image:
    if args[i] == "-e":
        key, _, value = args[i + 1].partition("=")
        env[key] = value
        i += 2
    elif args[i] in ("-v", "--gpus"):
        i += 2
    else:
        i += 1
cmd = args[image + 1:]
if cmd[0] == "python3":
    cmd[0] = sys.executable
os.execve(cmd[0], cmd, env)
"""


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """(runtime path, log path) of the stand-in container runtime."""
    d = tmp_path_factory.mktemp("standin")
    path, log = d / "runtime", d / "calls.jsonl"
    path.write_text(_STANDIN.format(python=sys.executable,
                                    image=STANDIN_IMAGE))
    path.chmod(0o755)
    return str(path), str(log)


@pytest.fixture(scope="module")
def cluster(standin):
    # The node's processes take the stand-in runtime from their start;
    # the test process itself keeps no such variable.
    saved = {k: os.environ.get(k) for k in (CONTAINER_VAR,
                                            "RTPU_STANDIN_LOG")}
    os.environ[CONTAINER_VAR], os.environ["RTPU_STANDIN_LOG"] = standin
    try:
        info = ray_tpu_torch.init(num_cpus=8, num_gpus=1,
                                  object_store_memory=128 * 1024 * 1024,
                                  ignore_reinit_error=True)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    yield info
    ray_tpu_torch.shutdown()


def _make_wheel(tmp_path, name="rtetest", version="0.1", value=123):
    """A minimal valid wheel, built by hand so no network is needed."""
    whl = str(tmp_path / f"{name}-{version}-py3-none-any.whl")
    with zipfile.ZipFile(whl, "w") as z:
        z.writestr(f"{name}/__init__.py", f"VALUE = {value}\n")
        z.writestr(f"{name}-{version}.dist-info/METADATA",
                   f"Metadata-Version: 2.1\nName: {name}\n"
                   f"Version: {version}\n")
        z.writestr(f"{name}-{version}.dist-info/WHEEL",
                   "Wheel-Version: 1.0\nGenerator: t\n"
                   "Root-Is-Purelib: true\nTag: py3-none-any\n")
        z.writestr(f"{name}-{version}.dist-info/RECORD", "")
    return whl


def test_env_vars_applied_and_isolated(cluster):
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"RTPU_TEST_FLAG": "on"}})
    def with_env():
        return os.environ.get("RTPU_TEST_FLAG")

    @ray_tpu_torch.remote
    def without_env():
        return os.environ.get("RTPU_TEST_FLAG")

    assert ray_tpu_torch.get(with_env.remote(), timeout=90) == "on"
    # Plain tasks run in a different worker pool: no leakage.
    assert ray_tpu_torch.get(without_env.remote(), timeout=90) is None


def test_distinct_envs_get_distinct_workers(cluster):
    @ray_tpu_torch.remote
    def whoami():
        return os.getpid(), os.environ.get("POOL")

    a = whoami.options(runtime_env={"env_vars": {"POOL": "a"}})
    b = whoami.options(runtime_env={"env_vars": {"POOL": "b"}})
    (pid_a, pool_a), (pid_b, pool_b) = ray_tpu_torch.get(
        [a.remote(), b.remote()], timeout=120)
    assert pool_a == "a" and pool_b == "b"
    assert pid_a != pid_b


def test_working_dir(cluster, tmp_path):
    (tmp_path / "data.txt").write_text("payload")

    @ray_tpu_torch.remote(runtime_env={"working_dir": str(tmp_path)})
    def read_local():
        return os.getcwd(), open("data.txt").read()

    cwd, content = ray_tpu_torch.get(read_local.remote(), timeout=90)
    # The dir is packaged by content hash and unpacked into the node
    # cache (so remote nodes see it too); cwd is the unpacked copy.
    assert content == "payload"
    assert cwd != str(tmp_path) and f"runtime_envs{os.sep}pkg" in cwd


def test_actor_runtime_env(cluster):
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"ACTOR_ENV": "yes"}})
    class EnvActor:
        def probe(self):
            return os.environ.get("ACTOR_ENV")

    actor = EnvActor.remote()
    assert ray_tpu_torch.get(actor.probe.remote(), timeout=120) == "yes"
    ray_tpu_torch.kill(actor)


def test_validation_errors():
    from ray_tpu_torch.runtime_env import (RuntimeEnvValidationError,
                                           validate_runtime_env)

    with pytest.raises(RuntimeEnvValidationError):
        validate_runtime_env({"bogus_field": 1})
    with pytest.raises(RuntimeEnvValidationError):
        validate_runtime_env({"env_vars": {"A": 1}})
    with pytest.raises(RuntimeEnvValidationError):
        validate_runtime_env({"conda": {"dependencies": []}})
    with pytest.raises(RuntimeEnvValidationError):
        validate_runtime_env({"working_dir": "/nonexistent/dir"})
    assert validate_runtime_env(None) == {}
    assert validate_runtime_env({"pip": ["requests"]}) == {
        "pip": {"packages": ["requests"]}}


def test_pip_env_task_runs_in_venv(cluster, tmp_path):
    """A task with a pip runtime_env imports a package the driver lacks;
    a second task with the same env reuses the cached venv (one creation).
    Reference: runtime_env pip plugin + URI cache
    (`_private/runtime_env/pip.py`)."""
    whl = _make_wheel(tmp_path, value=123)
    with pytest.raises(ImportError):
        import rtetest  # noqa: F401 — must NOT exist in the driver env

    @ray_tpu_torch.remote(runtime_env={"pip": [whl]})
    def get_value():
        import rtetest
        return rtetest.VALUE, sys.executable

    value, exe = ray_tpu_torch.get(get_value.remote(), timeout=300)
    assert value == 123
    assert f"pip{os.sep}" in exe, f"task ran outside the venv: {exe}"

    # Cache hit: same env spec must reuse the same interpreter.
    _value2, exe2 = ray_tpu_torch.get(get_value.remote(), timeout=300)
    assert exe2 == exe

    from ray_tpu_torch._private.worker import global_worker

    stats = global_worker().raylet.call("runtime_env_stats", timeout=15)
    pip_uris = [u for u in stats["cached_uris"] if u.startswith("pip:")]
    assert len(pip_uris) == 1, stats
    assert stats["create_seconds"][pip_uris[0]] > 0


def test_py_modules_import(cluster, tmp_path):
    mod = tmp_path / "rtemod"
    mod.mkdir()
    (mod / "__init__.py").write_text("WHO = 'packaged'\n")

    @ray_tpu_torch.remote(runtime_env={"py_modules": [str(mod)]})
    def read_mod():
        import rtemod
        return rtemod.WHO

    assert ray_tpu_torch.get(read_mod.remote(), timeout=300) == "packaged"


def test_actor_with_pip_env(cluster, tmp_path):
    whl = _make_wheel(tmp_path, name="rteactor", value=7)

    @ray_tpu_torch.remote(runtime_env={"pip": [whl]})
    class Holder:
        def probe(self):
            import rteactor
            return rteactor.VALUE, sys.executable, sorted(
                m for m in sys.modules
                if m.split(".")[0] in ("jax", "ray_tpu"))

    h = Holder.remote()
    value, exe, foreign = ray_tpu_torch.get(h.probe.remote(), timeout=300)
    # The venv's interpreter runs the port's worker, and only the port.
    assert value == 7 and f"pip{os.sep}" in exe and foreign == []
    ray_tpu_torch.kill(h)


def test_env_vars_cannot_make_a_card_visible(cluster):
    """The port's rule (its workers start with CUDA_VISIBLE_DEVICES=""):
    the raylet sets the variable back to "" after an env's ``env_vars``,
    so only a GPU lease makes a card visible, and it names the lease's
    card whatever the env said."""
    env = {"env_vars": {"CUDA_VISIBLE_DEVICES": "3", "OTHER": "kept"}}

    @ray_tpu_torch.remote(runtime_env=env)
    def unleased():
        return os.environ.get("CUDA_VISIBLE_DEVICES"), os.environ["OTHER"]

    @ray_tpu_torch.remote(num_gpus=1, runtime_env=env)
    def leased():
        return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                ray_tpu_torch.get_gpu_ids())

    assert ray_tpu_torch.get(unleased.remote(), timeout=90) == ("", "kept")
    assert ray_tpu_torch.get(leased.remote(), timeout=90) == ("0", [0])


def test_packaging_deterministic(tmp_path):
    from ray_tpu_torch.runtime_env import packaging

    d = tmp_path / "pkg"
    d.mkdir()
    (d / "a.py").write_text("A = 1\n")
    uri1, payload1 = packaging.package_dir(str(d))
    uri2, payload2 = packaging.package_dir(str(d))
    assert uri1 == uri2 and payload1 == payload2
    (d / "a.py").write_text("A = 2\n")
    uri3, _ = packaging.package_dir(str(d))
    assert uri3 != uri1


# ------------------------------------------------ package cache GC races

def test_gc_never_evicts_inflight_creation(tmp_path):
    """A URI whose per-URI creation lock is held is mid-download: GC
    must not rmtree it out from under _ensure_package even though no
    worker holds a ref yet."""
    import asyncio

    from ray_tpu_torch.runtime_env.manager import RuntimeEnvManager

    m = RuntimeEnvManager(str(tmp_path), None, cache_size_bytes=100)
    m._sizes = {"gcs://pkg.zip": 500}  # over cap, no refs yet

    async def gc_while_creating():
        async with m._lock("gcs://pkg.zip"):
            m._maybe_gc()

    asyncio.run(gc_while_creating())
    assert "gcs://pkg.zip" in m._sizes  # mid-creation: not a victim

    m._maybe_gc()  # lock released, still unreferenced: normal eviction
    assert "gcs://pkg.zip" not in m._sizes


def test_fresh_package_is_last_eviction_candidate(tmp_path, monkeypatch):
    """Creation stamps _last_used. Without the stamp a just-built
    package has no recency entry, sorts as oldest, and GC can delete
    it during the awaits between _ensure_package returning and setup()
    taking the ref."""
    import asyncio

    from ray_tpu_torch.runtime_env import packaging
    from ray_tpu_torch.runtime_env.manager import RuntimeEnvManager

    async def fake_download(_gcs, _uri):
        return b"x" * 64

    def fake_unpack(_payload, dest):
        os.makedirs(dest, exist_ok=True)
        with open(os.path.join(dest, ".rtpu_pkg_ready"), "w") as f:
            f.write("ok")

    monkeypatch.setattr(packaging, "download_package", fake_download)
    monkeypatch.setattr(packaging, "unpack_package", fake_unpack)

    m = RuntimeEnvManager(str(tmp_path), None, cache_size_bytes=10 ** 6)
    m._sizes["gcs://old.zip"] = 64
    m._last_used["gcs://old.zip"] = 0.0
    asyncio.run(m._ensure_package("gcs://fresh.zip"))
    assert "gcs://fresh.zip" in m._last_used

    m._cache_cap = 100  # both unreferenced; LRU must pick the idle one
    m._maybe_gc()
    assert "gcs://fresh.zip" in m._sizes
    assert "gcs://old.zip" not in m._sizes


# ----------------------------------------- parity with the JAX package


def _specs(tmp):
    """runtime_env specs, accepted and rejected, over real paths."""
    (tmp / "wd").mkdir()
    (tmp / "mod").mkdir()
    whl = _make_wheel(tmp, name="paritywhl")
    req = tmp / "requirements.txt"
    req.write_text("# pinned\nnumpy==1.0\n\nrequests\n")
    return {
        "none": None,
        "empty": {},
        "env_vars": {"env_vars": {"A": "1", "B": ""}},
        "working_dir": {"working_dir": str(tmp / "wd")},
        "working_dir_uri": {"working_dir": "gcs://_rtpu_pkg_0.zip"},
        "py_modules": {"py_modules": [str(tmp / "mod"), whl,
                                      "gcs://_rtpu_pkg_1.zip"]},
        "pip_list": {"pip": ["requests", whl]},
        "pip_dict": {"pip": {"packages": ["x"], "pip_check": False}},
        "pip_file": {"pip": str(req)},
        "config": {"config": {"setup_timeout_seconds": 5},
                   "excludes": ["*.log"]},
        "falsy_fields": {"env_vars": {}, "config": None, "excludes": []},
        "unknown": {"bogus": 1},
        "not_a_dict": ["env_vars"],
        "env_value_int": {"env_vars": {"A": 1}},
        "env_not_dict": {"env_vars": [("A", "1")]},
        "working_dir_missing": {"working_dir": str(tmp / "absent")},
        "working_dir_int": {"working_dir": 3},
        "py_modules_str": {"py_modules": str(tmp / "mod")},
        "py_modules_int": {"py_modules": [3]},
        "py_modules_missing": {"py_modules": [str(tmp / "absent.whl")]},
        "pip_file_missing": {"pip": str(tmp / "absent.txt")},
        "pip_int_entry": {"pip": ["ok", 3]},
        "pip_dict_no_packages": {"pip": {"index": "x"}},
        "pip_int": {"pip": 3},
        "conda": {"conda": {"dependencies": []}},
        "container_no_image": {"container": {"run_options": []}},
        "container_no_runtime": {"container": {"image": "img"}},
    }


_SPEC_NAMES = [
    "none", "empty", "env_vars", "working_dir", "working_dir_uri",
    "py_modules", "pip_list", "pip_dict", "pip_file", "config",
    "falsy_fields", "unknown", "not_a_dict", "env_value_int",
    "env_not_dict", "working_dir_missing", "working_dir_int",
    "py_modules_str", "py_modules_int", "py_modules_missing",
    "pip_file_missing", "pip_int_entry", "pip_dict_no_packages", "pip_int",
    "conda", "container_no_image", "container_no_runtime"]


def _validate(validate, spec):
    try:
        return "ok", validate(spec)
    except Exception as e:                 # the error's type and text
        return type(e).__name__, str(e)


@pytest.mark.parametrize("name", _SPEC_NAMES)
def test_validate_runtime_env_matches_reference(name, tmp_path, monkeypatch):
    """The same spec through both packages' ``validate_runtime_env``: the
    same normalized dict, or the same error type and text."""
    from ray_tpu.runtime_env import validate_runtime_env as ref_validate

    from ray_tpu_torch.runtime_env import validate_runtime_env

    monkeypatch.delenv("RAY_TPU_CONTAINER_RUNTIME", raising=False)
    spec = _specs(tmp_path)[name]
    want = _validate(ref_validate, spec)
    got = _validate(validate_runtime_env, spec)
    assert got == want
    if name in ("unknown", "conda", "env_value_int", "working_dir_missing"):
        assert got[0] == "RuntimeEnvValidationError"


def test_runtime_env_wrapper_matches_reference(tmp_path):
    from ray_tpu.runtime_env import RuntimeEnv as RefRuntimeEnv

    from ray_tpu_torch.runtime_env import RuntimeEnv

    kw = {"env_vars": {"A": "1"}, "working_dir": str(tmp_path)}
    assert RuntimeEnv(**kw).to_dict() == RefRuntimeEnv(**kw).to_dict()


def _tree(root):
    (root / "sub").mkdir(parents=True)
    (root / "__pycache__").mkdir()
    (root / "a.py").write_text("A = 1\n")
    (root / "sub" / "b.txt").write_bytes(bytes(range(256)) * 5)
    (root / "x.pyc").write_bytes(b"\0")
    (root / "__pycache__" / "a.cpython-312.pyc").write_bytes(b"\0")
    (root / "run.sh").write_text("#!/bin/sh\n")
    os.chmod(root / "run.sh", 0o755)
    (root / "skip.log").write_text("excluded\n")


@pytest.mark.parametrize("include_root_name", [False, True])
def test_packaging_matches_reference(tmp_path, include_root_name):
    """One directory zipped by both packages: the same content address
    and the same bytes (so a package is shared between them), with the
    same default and explicit excludes; the same for a wheel."""
    from ray_tpu.runtime_env import packaging as ref

    from ray_tpu_torch.runtime_env import packaging

    root = tmp_path / "pkgdir"
    _tree(root)
    for excludes in (None, ["skip.log"]):
        want = ref.package_dir(str(root), excludes, include_root_name)
        got = packaging.package_dir(str(root), excludes, include_root_name)
        assert got == want
    whl = _make_wheel(tmp_path, name="pkgwhl")
    assert packaging.package_wheel(whl) == ref.package_wheel(whl)
    uri, payload = got
    dest = tmp_path / "unpacked"
    packaging.unpack_package(payload, str(dest))
    prefix = dest / "pkgdir" if include_root_name else dest
    assert (prefix / "sub" / "b.txt").read_bytes() == \
        (root / "sub" / "b.txt").read_bytes()
    assert not (prefix / "x.pyc").exists()
    assert (prefix / "run.sh").read_text() == "#!/bin/sh\n"


# ------------------------------------------------------ container workers

def _spawn_command(raylet_mod, manager_cls, runtime_env, tmp_path,
                   monkeypatch, **kw):
    """(argv, env) a package's raylet would start a worker with for
    ``runtime_env``: its ``_spawn_worker_throttled`` on a stand-in raylet
    whose Popen records the call and fails."""
    import asyncio
    import collections
    import types

    recorded = {}

    def popen(cmd, **kwargs):
        recorded.update(cmd=list(cmd), env=dict(kwargs["env"]))
        raise OSError("recorded")

    monkeypatch.setattr(raylet_mod.subprocess, "Popen", popen)
    node = types.SimpleNamespace(
        session_dir=str(tmp_path), host="127.0.0.1",
        server=types.SimpleNamespace(port=1), gcs_addr=("127.0.0.1", 2),
        node_id=types.SimpleNamespace(hex=lambda: "ab" * 14),
        _starting=collections.defaultdict(int), _env_failures={},
        _pending_pop=collections.defaultdict(collections.deque))
    manager = manager_cls(str(tmp_path / "envs"), None)
    node._worker_env = lambda: {"PATH": "/usr/bin", "PYTHONPATH": "/pkg",
                                "RAY_TPU_NODE_ID": "ab" * 14,
                                "RAY_TPU_NODE_IP": "127.0.0.1"}
    node._runtime_env_manager = lambda: manager
    node._startup_sema = lambda: asyncio.Semaphore(1)
    node._spawn_failed = lambda e, out, *a: out.close()
    node._pool_key = raylet_mod.Raylet._pool_key
    if hasattr(raylet_mod.Raylet, "_container_command"):
        node._container_command = raylet_mod.Raylet._container_command
    asyncio.run(raylet_mod.Raylet._spawn_worker_throttled(
        node, b"\x01" * 4, runtime_env, b"pool", **kw))
    cmd = recorded["cmd"]
    cmd[cmd.index("--worker-id") + 1] = "<worker id>"
    return cmd, recorded["env"]


@pytest.mark.parametrize("gpu_ids", [[], [0]], ids=["no_gpu", "gpu0"])
def test_container_command_matches_reference(gpu_ids, tmp_path,
                                             monkeypatch):
    """The same container spec through both packages' manager and raylet
    spawn: the same ``<runtime> run`` prefix, run options, ``-e`` flags
    and image, with the port's one addition, ``-e CUDA_VISIBLE_DEVICES``
    naming the lease's cards; then the image's ``python3`` runs each
    package's own worker."""
    from ray_tpu._private import raylet as ref_raylet
    from ray_tpu.runtime_env.manager import RuntimeEnvManager as RefManager

    from ray_tpu_torch._private import raylet
    from ray_tpu_torch.runtime_env.manager import RuntimeEnvManager

    monkeypatch.setenv(CONTAINER_VAR, "/usr/bin/podman")
    spec = {"container": {"image": "img:1", "run_options": ["--gpus",
                                                            "all"]},
            "env_vars": {"A": "1"}}
    want, _ = _spawn_command(ref_raylet, RefManager, spec, tmp_path,
                             monkeypatch)
    got, env = _spawn_command(raylet, RuntimeEnvManager, spec, tmp_path,
                              monkeypatch, gpu_ids=gpu_ids)
    cuda = ["-e", "CUDA_VISIBLE_DEVICES=" + ",".join(map(str, gpu_ids))]
    image = want.index("img:1")
    assert want[:6] == ["/usr/bin/podman", "run", "--rm", "--network=host",
                        "-v", "/tmp:/tmp"]
    assert got[:image] + got[image + 2:] == [
        "ray_tpu_torch._private.worker_main" if a == "ray_tpu._private."
        "worker_main" else a for a in want]
    assert got[image:image + 2] == cuda
    assert got[image + 2:image + 4] == ["img:1", "python3"]
    # The Popen env is the container CLI's: the card stays hidden there.
    assert env["CUDA_VISIBLE_DEVICES"] == ""


def test_container_worker_runs_with_its_lease(cluster, standin,
                                              monkeypatch):
    """A ``num_gpus=1`` task in a container env runs through the
    stand-in runtime: its command passes the lease's card by ``-e`` and
    the user's run options, and the worker inside sees that card."""
    import json

    monkeypatch.setenv(CONTAINER_VAR, standin[0])
    env = {"container": {"image": STANDIN_IMAGE,
                         "run_options": ["--gpus", "all"]},
           "env_vars": {"RTPU_IN_CONTAINER": "yes"}}

    @ray_tpu_torch.remote(num_gpus=1, runtime_env=env)
    def inside():
        return (os.environ.get("RTPU_IN_CONTAINER"),
                os.environ.get("CUDA_VISIBLE_DEVICES"),
                ray_tpu_torch.get_gpu_ids())

    assert ray_tpu_torch.get(inside.remote(), timeout=120) == (
        "yes", "0", [0])
    with open(standin[1]) as f:
        calls = [json.loads(line) for line in f]
    argv = next(c for c in calls if STANDIN_IMAGE in c)
    image = argv.index(STANDIN_IMAGE)
    assert argv[1:4] == ["run", "--rm", "--network=host"]
    assert ["--gpus", "all"] == argv[6:8]
    flags = argv[8:image]
    assert "CUDA_VISIBLE_DEVICES=0" in flags
    assert "RTPU_IN_CONTAINER=yes" in flags
    assert argv[image + 1:image + 4] == [
        "python3", "-m", "ray_tpu_torch._private.worker_main"]
