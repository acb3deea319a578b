"""Compute Engine GPU-VM gang provider + node bootstrap command runner.

Reference shape: `python/ray/autoscaler/_private/gcp/node_provider.py`
(+ `command_runner.py` for SSH bootstrap), and the reference package's
TPU-VM provider, whose unit is a pod slice made by one API call. Here the
unit is a gang of GPU VMs: one Compute Engine ``instances.bulkInsert``
call creates every host of a gang (``count`` = ``minCount`` = the gang
size, so all or none), each of the node type's ``machine_type`` (an
``a3-highgpu-8g`` comes with its eight H100s). The ready wait lists the
gang's instances by label and reads each one's status and internal IP;
rollback on any failure deletes every host of the gang.

The REST transport and the per-host command runner are injectable:
production uses urllib against ``compute.googleapis.com`` with a
metadata-server access token and `ssh`; tests drive the full provider
logic with a fake Compute API and a capturing runner (reference:
`autoscaler/_private/fake_multi_node`), no cloud required.
"""

from __future__ import annotations

import json
import re as _re
import subprocess
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler.gpu_pod_provider import PodGroupProvider
from ray_tpu_torch.autoscaler.node_provider import GcsNodeTableMixin

COMPUTE_API = "https://compute.googleapis.com/compute/v1"

# Accelerator-optimized machine types by card, for a node type that names
# only ``gpu: <type>-<count>``: the count is the host's.
MACHINE_TYPES = {"H100": "a3-highgpu-{n}g", "A100": "a2-highgpu-{n}g"}

# Instance statuses a gang being created must not reach.
_FAILED = ("STOPPING", "STOPPED", "SUSPENDING", "SUSPENDED", "TERMINATED")


# ------------------------------------------------------------- transports

def rest_transport(method: str, url: str,
                   body: Optional[dict] = None, *,
                   timeout: float = 60.0) -> dict:
    """GCE-authenticated REST transport: urllib + metadata-server access
    token."""
    import urllib.request

    tok_req = urllib.request.Request(
        "http://metadata.google.internal/computeMetadata/v1/instance/"
        "service-accounts/default/token",
        headers={"Metadata-Flavor": "Google"})
    with urllib.request.urlopen(tok_req, timeout=5) as resp:
        token = json.loads(resp.read())["access_token"]
    req = urllib.request.Request(
        url, method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Authorization": f"Bearer {token}",
                 "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        payload = resp.read()
    return json.loads(payload) if payload else {}


class CommandRunner:
    """Runs a bootstrap command on one host (reference:
    `command_runner.py` SSHCommandRunner)."""

    def run(self, host_ip: str, command: str) -> None:
        raise NotImplementedError


class SSHCommandRunner(CommandRunner):
    def __init__(self, ssh_user: str = "ray", ssh_key: Optional[str] = None,
                 connect_timeout_s: int = 30):
        self._user = ssh_user
        self._key = ssh_key
        self._timeout = connect_timeout_s

    def run(self, host_ip: str, command: str) -> None:
        args = ["ssh", "-o", "StrictHostKeyChecking=no",
                "-o", f"ConnectTimeout={self._timeout}"]
        if self._key:
            args += ["-i", self._key]
        args += [f"{self._user}@{host_ip}", command]
        proc = subprocess.run(args, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"bootstrap failed on {host_ip}: {proc.stderr[-500:]}")


def rfc1035(raw: str) -> str:
    """A Compute Engine resource name ([a-z]([-a-z0-9]*[a-z0-9])?) from a
    config-legal one (dots, underscores and capitals are legal in OUR
    config but rejected by the API)."""
    return _re.sub(r"-+", "-",
                   _re.sub(r"[^a-z0-9-]", "-", raw.lower())).strip("-")


# --------------------------------------------------------------- provider

class GceGpuPodProvider(GcsNodeTableMixin, PodGroupProvider):
    """Gangs of Compute Engine GPU VMs as atomic node groups.

    ``provider_config``: {"project", "zone", "cluster_name", and optional
    "network", "source_image", "disk_size_gb"}; each node type's
    ``node_config`` carries {"machine_type": "a3-highgpu-8g", ...} or the
    ``gpu`` shorthand.
    """

    def __init__(self, provider_config: Dict[str, Any], gcs_addr,
                 transport: Callable[..., dict] = rest_transport,
                 command_runner: Optional[CommandRunner] = None,
                 ready_timeout_s: float = 900.0,
                 poll_interval_s: float = 5.0):
        self._cfg = provider_config
        self._gcs_addr = tuple(gcs_addr)
        self._t = transport
        self._runner = command_runner or SSHCommandRunner(
            ssh_user=provider_config.get("ssh_user", "ray"),
            ssh_key=provider_config.get("ssh_private_key"))
        self._ready_timeout = ready_timeout_s
        self._poll = poll_interval_s
        # group id -> {"type", "hosts": [ip...]}
        self._groups: Dict[str, Dict[str, Any]] = {}
        # provider node id ("<group>#<i>") -> cluster NodeID (bytes)
        self._internal_ids: Dict[str, Optional[bytes]] = {}

    # ------------------------------------------------------------- helpers
    def _cluster(self) -> str:
        return self._cfg.get("cluster_name", "cluster")

    def _zone_url(self) -> str:
        return (f"{COMPUTE_API}/projects/{self._cfg['project']}/zones/"
                f"{self._cfg['zone']}")

    def _instance_url(self, name: str) -> str:
        return f"{self._zone_url()}/instances/{name}"

    def _listing_url(self, label: str, value: str) -> str:
        return (f"{self._zone_url()}/instances?filter=labels.{label}"
                f"%3D{value}")

    def _bootstrap_command(self, group_id: str, worker_index: int,
                           node_config: Dict[str, Any]) -> str:
        host, port = self._gcs_addr
        resources = dict(node_config.get("resources", {}))
        if worker_index == 0:
            # Host 0 carries the promoted gang-head resource so one task
            # can gang-claim the hosts (same contract as
            # SubprocessPodProvider).
            resources.update(node_config.get("head_resources", {}))
        num_gpus = resources.pop("GPU", 0)
        cpus = resources.pop("CPU", None)
        return (f"python -m ray_tpu_torch start --address {host}:{port} "
                + (f"--num-cpus {cpus} " if cpus is not None else "")
                + f"--num-gpus {num_gpus} "
                f"--resources '{json.dumps(resources)}' "
                f"--labels '{{\"provider_group\": \"{group_id}\", "
                f"\"worker_index\": \"{worker_index}\"}}'")

    @staticmethod
    def _machine_type(node_config: Dict[str, Any]) -> str:
        """The Compute Engine machine type from either a bare node_config
        or a full node-type spec (the autoscaler passes the whole spec). A
        shorthand `gpu: H100-8` gives the accelerator-optimized type with
        a host's cards (`a3-highgpu-8g`)."""
        nc = node_config.get("node_config", node_config)
        mt = nc.get("machine_type") or node_config.get("machine_type")
        if mt:
            return mt
        gpu = node_config.get("gpu_type") or nc.get("gpu")
        if not gpu:
            raise ValueError(
                "node_config needs 'machine_type' (e.g. 'a3-highgpu-8g') "
                "or 'gpu' (e.g. 'H100-8')")
        from ray_tpu_torch.autoscaler.config import gpu_gang_shape

        card = gpu.rpartition("-")[0]
        per_host = node_config.get("resources", {}).get("GPU") or \
            gpu_gang_shape(gpu, nc.get("gpu_hosts"),
                           nc.get("gpus_per_host"))[1]
        if card not in MACHINE_TYPES:
            raise ValueError(
                f"no machine type known for {card} cards: declare "
                "node_config.machine_type")
        return MACHINE_TYPES[card].format(n=int(per_host))

    def _host_names(self, name: str, gang_size: int) -> List[str]:
        return [f"{name}-{i}" for i in range(gang_size)]

    # --------------------------------------------------------- group ops
    def create_node_group(self, node_type: str,
                          node_config: Dict[str, Any],
                          gang_size: int) -> str:
        name = rfc1035(f"ray-{self._cluster()}-{node_type}-"
                       f"{uuid.uuid4().hex[:8]}")
        body = {
            "count": gang_size,
            "minCount": gang_size,
            "perInstanceProperties": {
                h: {} for h in self._host_names(name, gang_size)},
            "instanceProperties": {
                "machineType": self._machine_type(node_config),
                "labels": {"ray-cluster": rfc1035(self._cluster()),
                           "ray-group": name},
                "metadata": {"items": [
                    {"key": "ray-cluster", "value": self._cluster()},
                    {"key": "ray-node-type", "value": node_type}]},
                # GPU VMs cannot live-migrate.
                "scheduling": {"onHostMaintenance": "TERMINATE",
                               "automaticRestart": False},
                # No accessConfigs: internal IPs only.
                "networkInterfaces": [{"network": self._cfg.get(
                    "network", "global/networks/default")}],
                "disks": [{"boot": True, "autoDelete": True,
                           "initializeParams": {
                               "sourceImage": self._cfg.get(
                                   "source_image",
                                   "projects/deeplearning-platform-release/"
                                   "global/images/family/common-cu124"),
                               "diskSizeGb": self._cfg.get(
                                   "disk_size_gb", 200)}}],
            },
        }
        op = self._t("POST", f"{self._zone_url()}/instances/bulkInsert",
                     body)
        try:
            hosts = self._wait_ready(name, gang_size, op.get("name"))
            for i, ip in enumerate(hosts):
                self._runner.run(
                    ip, self._bootstrap_command(name, i, node_config))
        except Exception:
            # Atomicity contract: a partial gang (API stuck, a host that
            # failed bootstrap) never leaks — tear the whole gang down.
            self._delete_hosts(name, gang_size)
            raise
        self._groups[name] = {"type": node_type, "hosts": hosts}
        for i in range(len(hosts)):
            self._internal_ids.setdefault(f"{name}#{i}", None)
        return name

    def _delete_hosts(self, name: str, gang_size: int) -> None:
        for host in self._host_names(name, gang_size):
            try:
                self._t("DELETE", self._instance_url(host))
            except Exception:
                pass

    def _wait_ready(self, name: str, gang_size: int,
                    op_name: Optional[str]) -> List[str]:
        deadline = time.monotonic() + self._ready_timeout
        while time.monotonic() < deadline:
            try:
                items = self._t("GET", self._listing_url(
                    "ray-group", name)).get("items", [])
            except Exception:
                # Transient transport blip (or the async insert not yet
                # visible): retry within the deadline instead of tearing
                # the gang down.
                time.sleep(self._poll)
                continue
            for inst in items:
                if inst.get("status") in _FAILED:
                    raise RuntimeError(
                        f"gang {name}: {inst.get('name')} entered "
                        f"{inst['status']} during creation")
            running = sorted(
                (i for i in items if i.get("status") == "RUNNING"),
                key=lambda i: int(i["name"].rsplit("-", 1)[1]))
            if items and len(running) == len(items):
                if len(running) >= gang_size:
                    return [i["networkInterfaces"][0]["networkIP"]
                            for i in running[:gang_size]]
                if op_name and self._op_done(op_name):
                    raise RuntimeError(
                        f"gang {name} RUNNING with {len(running)} hosts, "
                        f"expected {gang_size} (wrong machine_type for "
                        "this node type?)")
            time.sleep(self._poll)
        raise TimeoutError(
            f"gang {name} not RUNNING within {self._ready_timeout}s")

    def _op_done(self, op_name: str) -> bool:
        try:
            op = self._t("GET", f"{self._zone_url()}/operations/{op_name}")
        except Exception:
            return False
        return op.get("status") == "DONE"

    def terminate_node_group(self, group_id: str) -> None:
        info = self._groups.pop(group_id, None)
        n = len(info["hosts"]) if info else 1
        try:
            for host in self._host_names(group_id, n):
                self._t("DELETE", self._instance_url(host))
        finally:
            for i in range(n):
                self._internal_ids.pop(f"{group_id}#{i}", None)

    def node_groups(self) -> List[str]:
        return list(self._groups)

    def group_nodes(self, group_id: str) -> List[str]:
        info = self._groups.get(group_id)
        if not info:
            return []
        return [f"{group_id}#{i}" for i in range(len(info["hosts"]))]

    def group_type_of(self, group_id: str) -> Optional[str]:
        info = self._groups.get(group_id)
        return info["type"] if info else None

    # ---------------------------------------------------- per-node facade
    def create_node(self, node_type: str,
                    node_config: Dict[str, Any]) -> str:
        gid = self.create_node_group(node_type, node_config, 1)
        return f"{gid}#0"

    def terminate_node(self, provider_node_id: str) -> None:
        self.terminate_node_group(provider_node_id.split("#", 1)[0])

    def non_terminated_nodes(self) -> List[str]:
        return [n for g in self._groups for n in self.group_nodes(g)]

    def node_type_of(self, provider_node_id: str) -> Optional[str]:
        return self.group_type_of(provider_node_id.split("#", 1)[0])

    def internal_node_id(self, provider_node_id: str) -> Optional[bytes]:
        """Resolve via the GCS: bootstrapped raylets carry a
        provider_group/worker_index label."""
        cached = self._internal_ids.get(provider_node_id)
        if cached is not None:
            return cached
        group_id, _, idx = provider_node_id.partition("#")
        nodes = self._node_table()
        if nodes is None:
            return None
        for n in nodes or []:
            labels = n.get("labels") or {}
            if (labels.get("provider_group") == group_id
                    and labels.get("worker_index") == idx
                    and n.get("state") == "ALIVE"):
                self._internal_ids[provider_node_id] = n["node_id"]
                return n["node_id"]
        return None

    def refresh_groups(self) -> int:
        """Rediscover gangs this cluster owns (reference: the gcp
        provider's instances.list reconciliation): a restarted monitor
        must not orphan running gangs (idle-terminate stops working,
        billing runs forever) nor double-launch min_workers. Returns the
        number of groups adopted."""
        try:
            listing = self._t("GET", self._listing_url(
                "ray-cluster", rfc1035(self._cluster())))
        except Exception:
            return 0
        mine = self._cluster()
        found: Dict[str, Dict[str, Any]] = {}
        for inst in listing.get("items", []):
            meta = {m.get("key"): m.get("value") for m in
                    (inst.get("metadata") or {}).get("items", [])}
            group = (inst.get("labels") or {}).get("ray-group")
            if meta.get("ray-cluster") != mine or not group \
                    or group in self._groups:
                continue
            entry = found.setdefault(group, {
                "type": meta.get("ray-node-type", "unknown"), "hosts": {}})
            index = int(inst["name"].rsplit("-", 1)[1])
            entry["hosts"][index] = (inst.get("networkInterfaces")
                                     or [{}])[0].get("networkIP")
        for group, entry in found.items():
            self._groups[group] = {
                "type": entry["type"],
                "hosts": [entry["hosts"][i] for i in sorted(entry["hosts"])]}
        return len(found)

    def shutdown(self) -> None:
        for gid in list(self._groups):
            try:
                self.terminate_node_group(gid)
            except Exception:
                pass
