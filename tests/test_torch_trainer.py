"""The port's Train (``ray_tpu_torch/train``) against the reference's.

- ``run_pod_training``: per-step losses within 1e-5 of the JAX package's
  ``run_pod_training`` from the same initial params (the reference's
  ``init_params`` carried over with ``params_from_numpy``, monkeypatched
  in as ``cuda_backend`` sees it) on four routes, and the same returned
  keys. The reference needs a CPU mesh with exactly n devices, so it runs
  in a subprocess per device count.
- The trainers end to end on one CPU cluster: ``CudaTrainer(pod_train_loop)``,
  the applicable cases of ``tests/test_train.py`` with a torch MLP as the
  counterpart of its ``mlp_train_loop`` (2-worker data parallelism over
  gloo, keep-k checkpoints, resume, restart after a worker crash, the
  failure budget) and its three ``TorchTrainer`` cases.
- The refusals' error text: ``use_tpu``, ``datasets=``, ``as_trainable``,
  a gang of two on a card the host lacks, an ``fsdp`` axis, ``"data":
  -1``.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch import train  # noqa: E402
from ray_tpu_torch.train import (  # noqa: E402
    Checkpoint, CheckpointConfig, CudaConfig, CudaTrainer, FailureConfig,
    RunConfig, ScalingConfig, TorchTrainer, TrainingFailedError,
)
from ray_tpu_torch.train import cuda_backend  # noqa: E402
from ray_tpu_torch.train.cuda_backend import (  # noqa: E402
    pod_train_loop, run_pod_training,
)

ROOT = Path(__file__).resolve().parent.parent
TOL_LOSS = 1e-5
STEPS = 3
TINY = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            hidden_dim=128, max_seq_len=64)
# (route, n, run_pod_training kwargs)
ROUTES = {
    "replicated-1": (1, {}),
    "replicated-2": (2, {"mesh_axes": {"data": 2}}),
    "sharded-2": (2, {"mesh_axes": {"data": 2},
                      "weight_update": "sharded"}),
    "overlap-2": (2, {"mesh_axes": {"data": 2}, "overlap": True}),
}

_REFERENCE = r"""
import json, os, sys
n = int(sys.argv[1])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
import jax
try:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", n)
except Exception:
    pass
import jax.numpy as jnp
from ray_tpu.models.llama import LlamaConfig
from ray_tpu.train.jax_backend import run_pod_training
cfg = LlamaConfig(**json.loads(sys.argv[2]), dtype=jnp.float32)
out = {}
for name, kw in json.loads(sys.argv[3]).items():
    losses = []
    summary = run_pod_training(model_config=cfg, steps=int(sys.argv[4]),
                               report=lambda m: losses.append(m["loss"]),
                               **kw)
    out[name] = {"losses": losses, "keys": sorted(summary)}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_runs():
    """The JAX package's run_pod_training on every route: one subprocess
    per device count, started together."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    procs = []
    for n in sorted({n for n, _ in ROUTES.values()}):
        routes = {name: kw for name, (m, kw) in ROUTES.items() if m == n}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, str(n), json.dumps(TINY),
             json.dumps(routes), str(STEPS)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    out = {}
    for p in procs:
        stdout, stderr = p.communicate(timeout=170)
        assert p.returncode == 0, stderr[-3000:]
        line = next(ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT "))
        out.update(json.loads(line[len("RESULT "):]))
    return out


@pytest.fixture(scope="module")
def reference_params():
    """The reference's init_params(cfg, key(0)) as numpy."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from ray_tpu.models.llama import init_params

    tree = init_params(JaxLlamaConfig(**TINY, dtype=jnp.float32),
                       jax.random.key(0))
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _tiny_config():
    from ray_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(**TINY, dtype=torch.float32)


@pytest.mark.parametrize("route", list(ROUTES))
def test_run_pod_training_matches_reference(route, reference_runs,
                                            reference_params, monkeypatch):
    from ray_tpu_torch.models.convert import params_from_numpy

    monkeypatch.setattr(
        cuda_backend, "init_params",
        lambda config, seed=0, device=None: params_from_numpy(
            reference_params, config, device))
    _, kw = ROUTES[route]
    losses = []
    summary = run_pod_training(model_config=_tiny_config(), steps=STEPS,
                               device="cpu",
                               report=lambda m: losses.append(m["loss"]),
                               **kw)
    ref = reference_runs[route]
    assert sorted(summary) == ref["keys"]
    assert len(losses) == STEPS
    np.testing.assert_allclose(losses, ref["losses"], rtol=0, atol=TOL_LOSS)
    assert summary["loss"] == losses[-1]
    assert summary["mesh"] == {"data": kw.get("mesh_axes", {"data": 1})[
        "data"]}
    assert summary["weight_update"] == (
        "sharded" if kw.get("overlap") else kw.get("weight_update",
                                                   "replicated"))


def test_run_pod_training_refusals():
    """``fsdp`` and ``tensor`` axes at one worker are a mesh of virtual
    ranks now (``tests/test_torch_mesh_train.py``); what is refused is
    the overlap schedule on such a mesh (the reference's text) and a
    data ``-1`` with no device count to absorb."""
    cfg = _tiny_config()
    summary = run_pod_training(model_config=cfg,
                               mesh_axes={"data": 1, "fsdp": 2}, steps=1,
                               device="cpu")
    assert summary["mesh"] == {"data": 1, "fsdp": 2}
    with pytest.raises(ValueError, match="non-trivial axes"):
        run_pod_training(model_config=cfg, mesh_axes={"tensor": 2},
                         overlap=True, steps=1, device="cpu")
    with pytest.raises(ValueError, match="no device count to absorb"):
        run_pod_training(model_config=cfg, mesh_axes={"data": -1}, steps=1,
                         device="cpu")


# ------------------------------------------------------------ the cluster

@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(num_cpus=8, num_gpus=0,
                              object_store_memory=256 * 1024 * 1024,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


def test_cuda_trainer_pod_train_loop(cluster, tmp_path, reference_runs):
    """One CPU worker runs pod_train_loop; the summary comes back with the
    reference's keys, and the worker's steps reach the GCS step matrix."""
    from ray_tpu_torch.util import state

    result = CudaTrainer(
        pod_train_loop,
        train_loop_config={"model_config": _tiny_config(), "steps": 2},
        cuda_config=CudaConfig(device="cpu"),
        run_config=RunConfig(name="pod", storage_path=str(tmp_path)),
    ).fit()
    assert set(result.metrics) == set(reference_runs["replicated-1"]["keys"]) \
        | {"training_iteration", "timestamp"}
    assert result.metrics["steps"] == 2
    assert result.metrics["weight_update"] == "replicated"
    assert np.isfinite(result.metrics["loss"])
    assert result.metrics["goodput"]["lost_s"]["recompiling"] > 0
    assert len(result.metrics_dataframe) == 1
    assert result.path == str(tmp_path / "pod")
    rows = state.list_train_steps(worker="train-0")
    assert len(rows) >= 2 and rows[-1]["step"] == 1
    assert "compute" in rows[-1]["phases"]


def test_cuda_config_sets_the_loop_defaults(cluster, tmp_path):
    """CudaConfig's mesh and weight update reach pod_train_loop where its
    config leaves them out: the ZeRO route over two virtual ranks."""
    from ray_tpu_torch.util import state

    before = len(state.list_train_steps(worker="train-0", limit=10_000))
    result = CudaTrainer(
        pod_train_loop,
        train_loop_config={"model_config": _tiny_config(), "steps": 3},
        cuda_config=CudaConfig(device="cpu", weight_update="sharded",
                               mesh_axes={"data": 2}),
        run_config=RunConfig(name="zero", storage_path=str(tmp_path)),
    ).fit()
    assert result.metrics["weight_update"] == "sharded"
    assert result.metrics["mesh"] == {"data": 2}
    assert result.metrics["batch_size"] == 8
    assert len(result.metrics["step_walls"]) == 3
    after = state.list_train_steps(worker="train-0", limit=10_000)
    assert len(after) - before == 3
    summary = state.train_summary()
    row = next(r for r in summary["workers"] if r["worker"] == "train-0")
    assert row["done"] is True and row["stalled"] is False


def mlp_train_loop(config):
    """Data-parallel MLP regression: each worker takes its slice of the
    global batch and the gradients are averaged over gloo (the counterpart
    of tests/test_train.py's mlp_train_loop, whose pjit step averages
    over the global mesh)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.train import Checkpoint

    ctx = train.get_context()
    world = ctx.get_world_size()
    rank = ctx.get_world_rank()
    assert world == 1 or (dist.is_initialized()
                          and dist.get_world_size() == world
                          and dist.get_rank() == rank)

    rng = np.random.RandomState(0)
    w_true = rng.randn(8, 1).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    start_epoch = 0
    ckpt = ctx.get_checkpoint()
    if ckpt is not None:
        state = ckpt.to_pytree()
        params = state["params"]
        start_epoch = int(state["epoch"]) + 1
    else:
        params = {"w1": torch.randn(8, 32, generator=gen) * 0.1,
                  "b1": torch.zeros(32),
                  "w2": torch.randn(32, 1, generator=gen) * 0.1,
                  "b2": torch.zeros(1)}
    for p in params.values():
        p.requires_grad_(True)

    batch_global = 64
    epochs = config.get("epochs", 4)
    for epoch in range(start_epoch, epochs):
        x = torch.from_numpy(
            rng.randn(batch_global // world, 8).astype(np.float32))
        y = x @ torch.from_numpy(w_true)
        h = torch.tanh(x @ params["w1"] + params["b1"])
        loss = ((h @ params["w2"] + params["b2"] - y) ** 2).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        loss = loss.detach()
        if world > 1:
            for g in grads:
                dist.all_reduce(g)
                g /= world
            dist.all_reduce(loss)
            loss /= world
        with torch.no_grad():
            for p, g in zip(params.values(), grads):
                p -= 0.1 * g
        checkpoint = None
        if rank == 0:
            checkpoint = Checkpoint.from_pytree(
                {"params": {k: v.detach() for k, v in params.items()},
                 "epoch": epoch})
        train.report({"loss": float(loss), "epoch": epoch},
                     checkpoint=checkpoint)


def _mlp_trainer(tmp_path, name, workers, epochs, **kwargs):
    return CudaTrainer(
        mlp_train_loop, train_loop_config={"epochs": epochs},
        scaling_config=ScalingConfig(num_workers=workers),
        cuda_config=CudaConfig(device="cpu"),
        run_config=RunConfig(name=name, storage_path=str(tmp_path),
                             **kwargs.pop("run", {})),
        **kwargs)


class TestCudaTrainer:
    def test_dp_training_2workers(self, cluster, tmp_path):
        result = _mlp_trainer(tmp_path, "mlp-dp", 2, 4).fit()
        assert result.metrics["epoch"] == 3
        assert len(result.metrics_dataframe) == 4
        losses = [m["loss"] for m in result.metrics_dataframe]
        assert losses[-1] < losses[0]  # actually learning
        assert result.checkpoint is not None
        state = result.checkpoint.to_pytree()
        assert state["epoch"] == 3
        assert state["params"]["w1"].shape == (8, 32)

    def test_keep_k_checkpoints(self, cluster, tmp_path):
        result = _mlp_trainer(
            tmp_path, "mlp-keep", 1, 4,
            run={"checkpoint_config": CheckpointConfig(num_to_keep=2)}).fit()
        kept = sorted(d for d in os.listdir(tmp_path / "mlp-keep")
                      if d.startswith("checkpoint_"))
        assert kept == ["checkpoint_000002_rank0", "checkpoint_000003_rank0"]
        assert result.checkpoint.path.endswith("checkpoint_000003_rank0")

    def test_keep_k_by_score(self, cluster, tmp_path):
        result = _mlp_trainer(
            tmp_path, "mlp-score", 1, 4,
            run={"checkpoint_config": CheckpointConfig(
                num_to_keep=1, checkpoint_score_attribute="loss",
                checkpoint_score_order="min")}).fit()
        kept = [d for d in os.listdir(tmp_path / "mlp-score")
                if d.startswith("checkpoint_")]
        best = int(np.argmin([m["loss"] for m in result.metrics_dataframe]))
        assert kept == [f"checkpoint_{best:06d}_rank0"]

    def test_resume_from_checkpoint(self, cluster, tmp_path):
        r1 = _mlp_trainer(tmp_path, "mlp-r1", 2, 2).fit()
        assert r1.metrics["epoch"] == 1
        r2 = _mlp_trainer(tmp_path, "mlp-r2", 2, 4,
                          resume_from_checkpoint=r1.checkpoint).fit()
        # Resumed at epoch 2, so only epochs 2..3 ran.
        assert r2.metrics["epoch"] == 3
        assert len(r2.metrics_dataframe) == 2

    def test_single_worker(self, cluster, tmp_path):
        result = _mlp_trainer(tmp_path, "mlp-1w", 1, 2).fit()
        assert result.metrics["epoch"] == 1

    def test_failure_restart(self, cluster, tmp_path):
        """Worker crash mid-training: the gang restarts from the latest
        checkpoint (FailureConfig.max_failures, reference
        backend_executor._restart)."""

        def crashing_loop(config):
            import os

            from ray_tpu_torch import train
            from ray_tpu_torch.train import Checkpoint

            ctx = train.get_context()
            start = 0
            ckpt = ctx.get_checkpoint()
            if ckpt is not None:
                start = ckpt.to_dict()["epoch"] + 1
            marker = config["marker"]
            for epoch in range(start, 4):
                if epoch == 2 and ctx.get_world_rank() == 0 \
                        and not os.path.exists(marker):
                    open(marker, "w").close()
                    os._exit(1)  # hard crash, like a dead host
                checkpoint = None
                if ctx.get_world_rank() == 0:
                    checkpoint = Checkpoint.from_dict({"epoch": epoch})
                train.report({"epoch": epoch}, checkpoint=checkpoint)

        marker = str(tmp_path / "crashed.marker")
        result = CudaTrainer(
            crashing_loop, train_loop_config={"marker": marker},
            scaling_config=ScalingConfig(num_workers=2),
            cuda_config=CudaConfig(device="cpu"),
            run_config=RunConfig(
                name="mlp-ft", storage_path=str(tmp_path),
                failure_config=FailureConfig(max_failures=1)),
        ).fit()
        assert os.path.exists(marker)  # the crash really happened
        assert result.metrics["epoch"] == 3

    def test_failure_budget_exhausted(self, cluster, tmp_path):
        def always_fail(config):
            raise RuntimeError("deliberate")

        trainer = CudaTrainer(
            always_fail, scaling_config=ScalingConfig(num_workers=1),
            cuda_config=CudaConfig(device="cpu"),
            run_config=RunConfig(name="mlp-fail",
                                 storage_path=str(tmp_path)))
        with pytest.raises(TrainingFailedError, match="deliberate"):
            trainer.fit()


def test_trainer_syncs_checkpoints_to_storage(cluster, tmp_path,
                                              monkeypatch):
    """A URI storage path: every reported checkpoint syncs to the pyarrow
    filesystem, keep-k holds there too, and Result.checkpoint restores
    from the URI alone (``tests/test_storage.py``'s case)."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))  # the staging root

    def loop(config):
        from ray_tpu_torch import train
        from ray_tpu_torch.train import Checkpoint

        for step in range(3):
            train.report({"loss": 1.0 / (step + 1)},
                         checkpoint=Checkpoint.from_dict({"step": step}))

    result = CudaTrainer(
        loop, cuda_config=CudaConfig(device="cpu"),
        run_config=RunConfig(
            name="storage_e2e", storage_path=f"file://{tmp_path}/bucket",
            checkpoint_config=CheckpointConfig(num_to_keep=2))).fit()
    assert result.checkpoint is not None
    assert result.checkpoint.uri is not None
    restored = Checkpoint.from_uri(result.checkpoint.uri)
    assert restored.to_dict()["step"] == 2
    dirs = list((tmp_path / "bucket").rglob("checkpoint_*"))
    assert len({d.name for d in dirs}) == 2, dirs


# ------------------------------------------------------------ torch tier

def torch_ddp_loop(config):
    """DDP linear regression: gradients allreduce over gloo."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train

    ctx = train.get_context()
    assert dist.is_initialized() and dist.get_world_size() == 2
    assert dist.get_rank() == ctx.get_world_rank()

    torch.manual_seed(0)
    model = torch.nn.Linear(4, 1)
    ddp = torch.nn.parallel.DistributedDataParallel(model)
    opt = torch.optim.SGD(ddp.parameters(), lr=0.1)
    rng = np.random.RandomState(ctx.get_world_rank())
    w_true = np.arange(1.0, 5.0, dtype=np.float32)
    for i in range(30):
        x = torch.from_numpy(rng.randn(16, 4).astype(np.float32))
        y = (x @ torch.from_numpy(w_true))[:, None]
        loss = torch.nn.functional.mse_loss(ddp(x), y)
        opt.zero_grad(); loss.backward(); opt.step()
        train.report({"loss": float(loss)})
    # DDP sync proof, asserted ACROSS ranks: allreduce would be a no-op
    # on identical replicas, so gather both ranks' weights and compare.
    w = model.weight.detach().clone()
    gathered = [torch.zeros_like(w) for _ in range(2)]
    dist.all_gather(gathered, w)
    np.testing.assert_allclose(gathered[0].numpy(), gathered[1].numpy(),
                               rtol=0, atol=1e-6)
    train.report({"loss": float(loss), "synced": True})


def test_torch_trainer_ddp_gloo(cluster, tmp_path):
    """TorchTrainer forms a gloo process group over the same worker-group
    machinery as CudaTrainer (reference: train/torch/config.py:146)."""
    result = TorchTrainer(
        torch_ddp_loop, scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert result.error is None, result.error
    assert result.metrics["loss"] < 0.2, result.metrics
    assert result.metrics["synced"] is True
    # Each report was a step row; the finished loop marks its rows done,
    # so the stall watchdog never flags it.
    from ray_tpu_torch.util import state

    deadline = time.monotonic() + 10
    while True:
        rows = {r["worker"]: r for r in state.train_summary()["workers"]}
        if all(rows.get(w, {}).get("done") for w in ("rank0", "rank1")):
            break
        assert time.monotonic() < deadline, rows
        time.sleep(0.1)
    assert not rows["rank0"]["stalled"] and not rows["rank1"]["stalled"]


def test_torch_config_rejects_nccl():
    from ray_tpu_torch.train.torch_backend import TorchBackend, TorchConfig

    with pytest.raises(ValueError, match="gloo"):
        TorchBackend().on_start(
            type("G", (), {"num_workers": 2, "metadata": lambda s: [],
                           "execute_single": lambda s, *a: 0,
                           "workers": []})(),
            TorchConfig(backend="nccl"))


def test_torch_trainer_single_worker_group_forms(cluster, tmp_path):
    """world_size=1 still forms the gloo group: the docstring's DDP
    pattern must work at any scale."""

    def loop(config):
        import torch
        import torch.distributed as dist

        from ray_tpu_torch import train

        assert dist.is_initialized() and dist.get_world_size() == 1
        model = torch.nn.parallel.DistributedDataParallel(
            torch.nn.Linear(2, 1))
        out = model(torch.zeros(3, 2))
        train.report({"ok": float(out.shape[0])})

    result = TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert result.error is None, result.error
    assert result.metrics["ok"] == 3.0


# -------------------------------------------------------------- refusals

@pytest.mark.parametrize("field", [{"use_tpu": True},
                                   {"chips_per_worker": 4},
                                   {"topology": "v5e-16"}],
                         ids=["use_tpu", "chips_per_worker", "topology"])
def test_scaling_config_refuses_tpu_fields(field):
    with pytest.raises(ValueError, match="use_gpu=True and gpus_per_worker"):
        ScalingConfig(**field)


def test_scaling_config_leases_gpus():
    assert ScalingConfig(use_gpu=True).worker_resources() == {"CPU": 1,
                                                              "GPU": 1}
    assert ScalingConfig(use_gpu=True, gpus_per_worker=0.5) \
        .worker_resources() == {"CPU": 1, "GPU": 0.5}
    assert ScalingConfig().worker_resources() == {"CPU": 1}


def test_datasets_refused_naming_the_data_slice():
    with pytest.raises(NotImplementedError, match="Data slice"):
        CudaTrainer(pod_train_loop, datasets={"train": [1, 2, 3]})


def test_as_trainable_refused_naming_the_tune_slice():
    with pytest.raises(NotImplementedError, match="Tune slice"):
        CudaTrainer(pod_train_loop).as_trainable()


def test_get_dataset_shard_refused_naming_the_data_slice():
    with pytest.raises(NotImplementedError, match="Data slice"):
        train.get_dataset_shard("train")


def test_gpu_gang_of_two_refused(cluster, tmp_path):
    """Two workers on the card (CudaConfig's default device) are two ranks
    of one ZeRO step in two processes: the backend forms their ``cuda``
    collective group on the card, which raises in workers whose process
    has no CUDA device, naming the missing card; the workers are torn
    down."""
    before = ray_tpu_torch.available_resources().get("CPU")
    with pytest.raises(TrainingFailedError,
                       match="no CUDA device available"):
        CudaTrainer(pod_train_loop,
                    scaling_config=ScalingConfig(num_workers=2),
                    run_config=RunConfig(storage_path=str(tmp_path))).fit()
    deadline = time.monotonic() + 30
    while ray_tpu_torch.available_resources().get("CPU") < before:
        assert time.monotonic() < deadline, "the workers were not released"
        time.sleep(0.1)


def test_checkpoint_round_trip_in_session_dir(cluster, tmp_path):
    """A checkpoint reported from a worker persists under the run's
    directory and reads back on the driver."""

    def loop():
        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.train import Checkpoint

        tree = {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)}
        train.report({"done": 1}, checkpoint=Checkpoint.from_pytree(tree))

    result = CudaTrainer(
        loop, cuda_config=CudaConfig(device="cpu"),
        run_config=RunConfig(name="ck", storage_path=str(tmp_path))).fit()
    assert isinstance(result.checkpoint, Checkpoint)
    assert result.checkpoint.path.startswith(str(tmp_path / "ck"))
    w = result.checkpoint.to_pytree()["w"]
    assert w.dtype == torch.bfloat16
    assert torch.equal(w, torch.arange(6, dtype=torch.bfloat16).reshape(2, 3))
