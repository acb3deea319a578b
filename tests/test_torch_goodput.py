"""The port's training goodput & straggler observability
(``ray_tpu_torch/observability/goodput.py`` + the GCS step matrix and
stall watchdog): ``tests/test_train_goodput.py`` on the port.

Unit tier: the StepPhases ledger partitions step wall into phases
(exposed-collective carved out of compute), the GoodputLedger's
productive-vs-lost accounting, the StragglerDetector's dominant-phase
attribution, the same flags as the reference's detector on one sequence,
and the port's ``run_pod_training`` with the knob on and off. Cluster
tier: synthetic step rows through the real report_train_steps RPC drive
the straggler event and the train_summary rollup; a real actor that
publishes rows and then hangs trips the stall watchdog, whose TRAIN_STALL
event arrives with the worker's thread stacks attached. (The reference's
``GET /api/train`` case needs the dashboard, which the port has not.)
"""

import os
import time

import pytest

torch = pytest.importorskip("torch")


# --------------------------------------------------------------- unit tier

class TestStepPhases:
    def test_phases_partition_wall(self):
        from ray_tpu_torch.observability.goodput import StepPhases

        sp = StepPhases(step=1, worker="u0")
        with sp.phase("compute"):
            time.sleep(0.03)
        sp.add("data_wait", 0.01)
        row = sp.finish(publish=False)
        assert row["worker"] == "u0" and row["step"] == 1
        assert set(row["phases"]) == {"compute", "data_wait"}
        # Per-phase sums match the step wall within 5%.
        assert sum(row["phases"].values()) == pytest.approx(
            row["wall_s"], rel=0.05)

    def test_exposed_collective_carved_out_of_compute(self):
        from ray_tpu_torch.observability.goodput import StepPhases

        sp = StepPhases(step=2, worker="u0")
        with sp.phase("compute"):
            time.sleep(0.05)
        sp.note_exposed(0.02)
        row = sp.finish(publish=False)
        assert row["phases"]["exposed_collective"] == pytest.approx(0.02)
        assert row["phases"]["compute"] == pytest.approx(
            row["wall_s"] - 0.02 - row["phases"].get("data_wait", 0.0),
            rel=0.1)
        assert sum(row["phases"].values()) == pytest.approx(
            row["wall_s"], rel=0.05)

    def test_note_exposed_collective_lands_in_active_step(self):
        from ray_tpu_torch.observability.goodput import (
            StepPhases, note_exposed_collective)

        sp = StepPhases(step=5, worker="u0")
        with sp.phase("compute"):
            time.sleep(0.03)
            note_exposed_collective(0.01)
        row = sp.finish(publish=False)
        assert row["phases"]["exposed_collective"] == pytest.approx(0.01)

    def test_unknown_phase_rejected(self):
        from ray_tpu_torch.observability.goodput import StepPhases

        sp = StepPhases(step=3, worker="u0")
        with pytest.raises(ValueError):
            sp.add("mystery", 0.1)
        sp.finish(publish=False)

    def test_record_checkpoint_lands_in_active_step(self):
        from ray_tpu_torch.observability.goodput import (StepPhases,
                                                         record_checkpoint)

        sp = StepPhases(step=4, worker="u0")
        record_checkpoint(0.07)
        row = sp.finish(publish=False)
        assert row["phases"]["checkpoint"] == pytest.approx(0.07)


class TestGoodputLedger:
    def test_ratio_drops_with_lost_time(self):
        from ray_tpu_torch.observability.goodput import GoodputLedger

        led = GoodputLedger(worker="u1")
        led.note_productive(3.0)
        assert led.ratio() == pytest.approx(1.0)
        led.lose("stalled", 1.0)
        assert led.ratio() == pytest.approx(0.75)
        snap = led.snapshot()
        assert snap["productive_s"] == pytest.approx(3.0)
        assert snap["lost_s"]["stalled"] == pytest.approx(1.0)
        assert snap["accounted_s"] == pytest.approx(4.0)
        assert snap["goodput_ratio"] == pytest.approx(0.75)

    def test_unknown_cause_rejected(self):
        from ray_tpu_torch.observability.goodput import GoodputLedger

        with pytest.raises(ValueError):
            GoodputLedger(worker="u1").lose("gremlins", 1.0)

    def test_book_phases_classifies(self):
        from ray_tpu_torch.observability.goodput import GoodputLedger

        led = GoodputLedger(worker="u2")
        led.book_phases({"compute": 2.0, "optimizer": 1.0,
                         "data_wait": 0.5, "h2d": 0.25,
                         "exposed_collective": 0.25,
                         "checkpoint": 1.0})
        snap = led.snapshot()
        assert snap["productive_s"] == pytest.approx(3.0)
        assert snap["lost_s"]["stalled"] == pytest.approx(1.0)
        assert snap["lost_s"]["checkpointing"] == pytest.approx(1.0)
        assert snap["goodput_ratio"] == pytest.approx(3.0 / 5.0)

    def test_recompile_books_on_active_ledger(self):
        from ray_tpu_torch.observability.goodput import (GoodputLedger,
                                                         record_recompile,
                                                         set_active_ledger)

        led = GoodputLedger(worker="u3")
        set_active_ledger(led)
        try:
            record_recompile(2.5)
        finally:
            set_active_ledger(None)
        assert led.snapshot()["lost_s"]["recompiling"] == pytest.approx(2.5)


def _feed(det, steps, slow_worker="c", slow_phases=None):
    flags = []
    for step in range(steps):
        for w in ("a", "b", slow_worker):
            if w == slow_worker:
                phases = dict(slow_phases or
                              {"compute": 0.1, "data_wait": 0.2})
            else:
                phases = {"compute": 0.08, "data_wait": 0.02}
            f = det.observe(w, step, sum(phases.values()), phases)
            if f:
                flags.append(f)
    return flags


class TestStragglerDetector:
    def test_flags_slow_worker_with_dominant_phase(self):
        from ray_tpu_torch.observability.goodput import StragglerDetector

        flags = _feed(StragglerDetector(threshold=1.5, window=4), steps=8)
        assert flags
        flag = flags[-1]
        assert flag["worker"] == "c"
        assert flag["ratio"] > 1.5
        # compute is bigger in absolute terms on every worker; the
        # dominant phase is the one with the largest EXCESS over the
        # peer median, here the injected data wait.
        assert flag["dominant_phase"] == "data_wait"
        assert flag["dominant_excess_s"] > 0

    def test_uniform_pod_never_flags(self):
        from ray_tpu_torch.observability.goodput import StragglerDetector

        assert _feed(StragglerDetector(threshold=1.5, window=4), steps=8,
                     slow_phases={"compute": 0.08,
                                  "data_wait": 0.02}) == []

    def test_single_worker_never_flags(self):
        from ray_tpu_torch.observability.goodput import StragglerDetector

        det = StragglerDetector(threshold=1.5, window=4)
        for step in range(8):
            assert det.observe("only", step, 1.0, {"compute": 1.0}) is None

    @pytest.mark.parametrize("slow", [{"compute": 0.1, "data_wait": 0.2},
                                      {"compute": 0.4, "data_wait": 0.02},
                                      {"compute": 0.08, "data_wait": 0.02}],
                             ids=["data_wait", "compute", "uniform"])
    def test_flags_equal_the_reference(self, slow):
        from ray_tpu.observability.goodput import \
            StragglerDetector as RefDetector
        from ray_tpu_torch.observability.goodput import StragglerDetector

        ours = _feed(StragglerDetector(threshold=1.5, window=4), 16,
                     slow_phases=slow)
        theirs = _feed(RefDetector(threshold=1.5, window=4), 16,
                       slow_phases=slow)
        assert ours == theirs


def test_classify_phase():
    from ray_tpu_torch.observability.goodput import (TRAIN_PHASES,
                                                     classify_phase)

    assert classify_phase("compute") == "productive"
    assert classify_phase("optimizer") == "productive"
    for ph in ("data_wait", "h2d", "exposed_collective"):
        assert classify_phase(ph) == "stalled"
    for ph in ("checkpoint", "weight_publish"):
        assert classify_phase(ph) == "checkpointing"
    for ph in TRAIN_PHASES:
        assert classify_phase(ph) in ("productive", "stalled",
                                      "checkpointing")


def test_phase_vocabulary_is_the_reference():
    from ray_tpu.observability import goodput as ref
    from ray_tpu_torch.observability import goodput as ours

    assert ours.TRAIN_PHASES == ref.TRAIN_PHASES
    assert ours.GOODPUT_CAUSES == ref.GOODPUT_CAUSES
    assert ours._PHASE_CLASS == ref._PHASE_CLASS


def test_batch_num_samples():
    from ray_tpu_torch.observability.train import batch_num_samples

    assert batch_num_samples({"obs": torch.zeros(5, 3),
                              "act": [torch.zeros(5)]}) == 5
    assert batch_num_samples({}) == 0


# ------------------------------------------- run_pod_training instrumentation

def _tiny_config():
    from ray_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, hidden_dim=128, max_seq_len=64,
                       dtype=torch.float32)


def test_run_pod_training_emits_goodput_block():
    from ray_tpu_torch.train.cuda_backend import run_pod_training

    summary = run_pod_training(model_config=_tiny_config(),
                               mesh_axes={"data": 2}, steps=3,
                               weight_update="sharded", device="cpu")
    g = summary["goodput"]
    assert g["worker"] == "train-0"
    assert 0.0 < g["goodput_ratio"] <= 1.0
    assert g["accounted_s"] > 0
    # The warmup step is booked as lost-to-recompiling, not silently
    # blended into productive time.
    assert g["lost_s"]["recompiling"] > 0
    # Per-step phase sums match each step's wall within tolerance.
    assert len(summary["step_walls"]) == 3
    assert summary["phase_seconds"]["compute"] == pytest.approx(
        sum(summary["step_walls"]), rel=0.05)


def test_run_pod_training_knob_off_is_clean(monkeypatch):
    from ray_tpu_torch.train.cuda_backend import run_pod_training

    monkeypatch.setenv("RAY_TPU_train_goodput_instrumentation", "0")
    summary = run_pod_training(model_config=_tiny_config(),
                               mesh_axes={"data": 2}, steps=2,
                               weight_update="sharded", device="cpu")
    assert "goodput" not in summary
    assert "step_walls" not in summary
    assert "phase_seconds" not in summary
    assert summary["steps"] == 2


# ----------------------------------------------------------- cluster tier

@pytest.fixture(scope="module")
def train_cluster():
    import ray_tpu_torch

    # Shrink the watchdog so the stall test fires in seconds; config
    # resolution is env-first, so the GCS picks these up live.
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_train_stall_min_timeout_s", "2.0")
        mp.setenv("RAY_TPU_train_stall_check_interval_s", "0.25")
        info = ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                                  object_store_memory=128 * 1024 * 1024,
                                  ignore_reinit_error=True)
        yield info
        ray_tpu_torch.shutdown()


def _publish_matrix(gcs, steps=8):
    """Three synthetic workers, one 3x slower with the slowdown in
    data_wait; ends with done rows so the stall watchdog ignores
    them afterwards."""
    for step in range(steps):
        for w, phases in (
                ("m-a", {"compute": 0.08, "data_wait": 0.02}),
                ("m-b", {"compute": 0.08, "data_wait": 0.02}),
                ("m-slow", {"compute": 0.1, "data_wait": 0.2})):
            row = {"worker": w, "step": step,
                   "wall_s": sum(phases.values()), "phases": phases}
            if w == "m-slow":
                row["goodput"] = {
                    "worker": w, "wall_s": 10.0, "productive_s": 6.0,
                    "lost_s": {"stalled": 4.0}, "accounted_s": 10.0,
                    "goodput_ratio": 0.6}
            gcs.call("report_train_steps", row=row)
    for w in ("m-a", "m-b", "m-slow"):
        gcs.call("report_train_steps", row={"worker": w, "done": True})


def test_step_matrix_straggler_and_summary(train_cluster):
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.util import state

    gcs = global_worker().gcs
    _publish_matrix(gcs)

    # Matrix rows, filtered per worker.
    rows = state.list_train_steps(worker="m-slow")
    assert rows and all(r["worker"] == "m-slow" for r in rows)
    assert rows[-1]["phases"]["data_wait"] == pytest.approx(0.2)
    assert len(state.list_train_steps(worker="m-slow", limit=3)) == 3

    # The straggler event names the worker AND the dominant phase.
    events = state.list_cluster_events(event_type="TRAIN_STRAGGLER")
    ev = next(e for e in events if e.get("worker") == "m-slow")
    assert ev["severity"] == "WARNING"
    assert ev["dominant_phase"] == "data_wait"
    assert ev["ratio"] > 1.5
    assert "m-slow" in ev["message"] and "data_wait" in ev["message"]

    # The rollup: per-worker rows, straggler flag, goodput aggregation.
    summary = state.train_summary()
    by_worker = {r["worker"]: r for r in summary["workers"]}
    assert {"m-a", "m-b", "m-slow"} <= set(by_worker)
    assert by_worker["m-slow"]["straggler"]["dominant_phase"] == "data_wait"
    assert by_worker["m-slow"]["done"] is True
    assert by_worker["m-slow"]["mean_step_s"] > \
        2 * by_worker["m-a"]["mean_step_s"]
    assert summary["goodput_ratio"] == pytest.approx(0.6)
    assert summary["lost_seconds"]["stalled"] == pytest.approx(4.0)
    assert summary["phase_mean_s"]["data_wait"] > 0
    assert any(f["worker"] == "m-slow" for f in summary["stragglers"])


def test_malformed_row_is_dropped(train_cluster):
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.util import state

    gcs = global_worker().gcs
    before = state.train_summary()["steps_recorded"]
    assert gcs.call("report_train_steps",
                    rows=[{"worker": "bad", "step": "x"}, {"step": 1}])
    assert state.train_summary()["steps_recorded"] == before


def test_stall_watchdog_captures_stacks(train_cluster):
    import ray_tpu_torch
    from ray_tpu_torch.util import state

    @ray_tpu_torch.remote(num_cpus=1)
    class Trainer:
        def run_steps(self, n):
            from ray_tpu_torch.observability.goodput import (
                publish_train_step)

            for i in range(n):
                publish_train_step({
                    "worker": "stall-w", "step": i, "wall_s": 0.01,
                    "phases": {"compute": 0.01}})
            return True

        def ping(self):
            return "pong"

    t = Trainer.remote()
    assert ray_tpu_torch.get(t.run_steps.remote(3), timeout=60)
    # The actor now idles without a done marker: the watchdog must flag
    # it within max(2s floor, 3 heartbeats x ~10ms median) + interval.
    deadline = time.monotonic() + 30
    ev = None
    while time.monotonic() < deadline and ev is None:
        events = state.list_cluster_events(event_type="TRAIN_STALL")
        ev = next((e for e in events if e.get("worker") == "stall-w"),
                  None)
        time.sleep(0.25)
    assert ev is not None, "stall watchdog never fired"
    assert ev["severity"] == "ERROR"
    assert ev["last_step"] == 2
    # Auto-forensics: the stalled worker's thread stacks ride the event.
    stacks = ev.get("stacks") or ""
    assert "--- thread" in stacks, f"no stacks attached: {ev}"

    summary = state.train_summary()
    row = next(r for r in summary["workers"] if r["worker"] == "stall-w")
    assert row["stalled"] is True
    assert "stall-w" in summary["stalled"]

    # A fresh row revives the worker: stalled clears.
    assert ray_tpu_torch.get(t.run_steps.remote(1), timeout=60)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        summary = state.train_summary()
        row = next(r for r in summary["workers"]
                   if r["worker"] == "stall-w")
        if not row["stalled"]:
            break
        time.sleep(0.25)
    assert row["stalled"] is False
    ray_tpu_torch.kill(t)


def test_goodput_metrics_exported(train_cluster):
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.observability.goodput import (GoodputLedger,
                                                     StepPhases,
                                                     goodput_metrics)
    from ray_tpu_torch.util import metrics

    goodput_metrics()  # declare in this process
    led = GoodputLedger(worker="export-w")
    sp = StepPhases(step=1, worker="export-w", ledger=led)
    with sp.phase("compute"):
        time.sleep(0.01)
    sp.finish(publish=False)
    led.lose("stalled", 0.5)
    assert metrics.flush()
    text = global_worker().gcs.call("metrics_text")
    assert "rtpu_train_step_phase_seconds" in text
    assert 'phase="compute"' in text
    assert "rtpu_train_goodput_ratio" in text
    assert "rtpu_train_lost_seconds_total" in text
    assert 'cause="stalled"' in text


def test_run_pod_training_in_a_driver_feeds_the_matrix(train_cluster):
    """In a connected process the loop's rows reach the GCS: one row per
    timed step, then the done marker (no stall)."""
    from ray_tpu_torch.train.cuda_backend import run_pod_training
    from ray_tpu_torch.util import state

    before = len(state.list_train_steps(worker="train-0", limit=10_000))
    run_pod_training(model_config=_tiny_config(), steps=3, device="cpu")
    deadline = time.monotonic() + 10
    while True:
        rows = state.list_train_steps(worker="train-0", limit=10_000)
        info = next((r for r in state.train_summary()["workers"]
                     if r["worker"] == "train-0"), {})
        if len(rows) - before == 3 and info.get("done"):
            break
        assert time.monotonic() < deadline, (len(rows), before, info)
        time.sleep(0.1)
    assert [r["step"] for r in rows[-3:]] == [0, 1, 2]
    assert all("compute" in r["phases"] for r in rows[-3:])
    assert not info["stalled"]
    assert os.environ.get("RAY_TPU_train_goodput_instrumentation") is None
