"""KubeRay-equivalent node provider — Ray worker pods on Kubernetes.

Reference: `python/ray/autoscaler/_private/kuberay/node_provider.py:1`
(the kuberay node provider: scale requests are PATCHes to the RayCluster
custom resource's ``workerGroupSpecs[*].replicas`` +
``scaleStrategy.workersToDelete``; the kuberay operator reconciles pods
to match, and pod state is read back through the core v1 API). This is a
from-scratch redesign of the same contract:

* Declarative scaling only — the provider NEVER creates pods itself. It
  patches the RayCluster CR (optimistic-concurrency read-modify-write on
  ``metadata.resourceVersion``, retried on 409) and waits for the
  operator to materialize/delete pods, observed via label-selected pod
  listings.
* Multi-host GPU gangs map to kuberay's multi-host worker groups
  (``numOfHosts`` > 1): one replica of such a group is a GANG of pods
  sharing a ``ray.io/replica-index`` label. `create_node_group` bumps
  replicas by one and returns the new replica-index as the group id —
  the whole gang scales atomically, exactly like the Compute Engine
  provider's one bulk insert per gang (`gcp_gpu_provider.py`).
* Ray-node identity: a joined pod is matched to its cluster NodeID by
  pod IP against the GCS node table (pods run
  ``python -m ray_tpu_torch start`` from the CR's pod template; no SSH
  bootstrap exists or is needed on k8s).

Works against any API server reachable over REST; in production inside a
pod it uses the mounted serviceaccount token. Tests inject a fake
transport (`tests/test_torch_kuberay_provider.py`).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import (
    GcsNodeTableMixin, NodeProvider,
)

SA_TOKEN = "/var/run/secrets/kubernetes.io/serviceaccount/token"  # noqa: S105


def k8s_transport(api_server: str,
                  token_path: str = SA_TOKEN) -> Callable:
    """REST transport against the Kubernetes API server (urllib only —
    the kubernetes client library is deliberately not a dependency)."""
    import ssl
    import urllib.request

    def read_token() -> str:
        # Re-read per request: bound serviceaccount tokens rotate on
        # disk (~1h validity); caching the boot-time string 401s a
        # long-running autoscaler.
        if os.path.exists(token_path):
            with open(token_path) as f:
                return f.read().strip()
        return ""

    ctx = ssl.create_default_context()
    ca_path = os.path.join(os.path.dirname(token_path), "ca.crt")
    if os.path.exists(ca_path):
        # In-cluster: verify the API server against the mounted
        # serviceaccount CA — the bearer token must never travel over an
        # unverified channel.
        ctx.load_verify_locations(ca_path)
    elif os.environ.get("RAY_TPU_K8S_INSECURE") == "1":
        # Explicit opt-out only (dev clusters without a CA mount).
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE

    def transport(method: str, path: str, body: Optional[dict] = None,
                  content_type: str = "application/json"):
        import urllib.error

        req = urllib.request.Request(
            api_server.rstrip("/") + path,
            data=json.dumps(body).encode() if body is not None else None,
            method=method,
            headers={"Authorization": f"Bearer {read_token()}",
                     "Content-Type": content_type,
                     "Accept": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30,
                                        context=ctx) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            if e.code == 409:
                raise Conflict(str(e)) from e
            raise

    return transport


class KubeRayError(RuntimeError):
    pass


class Conflict(KubeRayError):
    """resourceVersion conflict (concurrent CR writer); retried."""


class KubeRayProvider(GcsNodeTableMixin, NodeProvider):
    """Drives one RayCluster CR's worker groups."""

    CRD_PATH = "/apis/ray.io/v1/namespaces/{ns}/rayclusters/{name}"
    PODS_PATH = "/api/v1/namespaces/{ns}/pods"

    def __init__(self, provider_config: Dict[str, Any], gcs_addr,
                 transport: Optional[Callable] = None,
                 ready_timeout_s: float = 300.0,
                 poll_interval_s: float = 2.0):
        self._cfg = provider_config
        self._ns = provider_config.get("namespace", "default")
        self._name = provider_config.get("cluster_name", "raycluster")
        self._gcs_addr = tuple(gcs_addr) if gcs_addr else None
        self._t = transport or k8s_transport(
            provider_config.get("api_server",
                                "https://kubernetes.default.svc"))
        self._ready_timeout = ready_timeout_s
        self._poll = poll_interval_s
        self._internal_ids: Dict[str, bytes] = {}
        self._pods_cache: Dict[str, tuple] = {}

    # ------------------------------------------------------------- CR I/O
    def _cr_path(self) -> str:
        return self.CRD_PATH.format(ns=self._ns, name=self._name)

    def _get_cr(self) -> dict:
        return self._t("GET", self._cr_path())

    def _update_cr(self, mutate: Callable[[dict], None]) -> dict:
        """Optimistic-concurrency read-modify-write, retried on 409 —
        the operator and other autoscaler replicas write the same CR."""
        for _ in range(8):
            cr = self._get_cr()
            mutate(cr)
            try:
                out = self._t("PUT", self._cr_path(), cr)
                # Any CR write changes the pod set (operator reconcile):
                # serve the next read fresh, not from the TTL cache.
                self._pods_cache.clear()
                return out
            except Conflict:
                time.sleep(0.1)
            except Exception as e:
                if "409" in str(e):
                    time.sleep(0.1)
                    continue
                raise
        raise KubeRayError("persistent RayCluster resourceVersion "
                           "conflict; giving up")

    def _group_spec(self, cr: dict, node_type: str) -> dict:
        for spec in cr.get("spec", {}).get("workerGroupSpecs", []):
            if spec.get("groupName") == node_type:
                return spec
        raise KubeRayError(
            f"RayCluster {self._name!r} has no workerGroupSpec "
            f"{node_type!r}; declare it in the CR before autoscaling it")

    # --------------------------------------------------------------- pods
    _PODS_TTL_S = 2.0

    def _pods(self, extra_selector: str = "",
              fresh: bool = False) -> List[dict]:
        """Label-selected pod listing with a short TTL cache: one
        reconcile pass calls node_type_of/internal_node_id/group_nodes
        per node — uncached that is O(N) identical LIST requests per
        pass (API-server throttling). Wait loops pass fresh=True."""
        sel = f"ray.io/cluster={self._name},ray.io/node-type=worker"
        if extra_selector:
            sel += "," + extra_selector
        now = time.monotonic()
        cached = self._pods_cache.get(sel)
        if not fresh and cached is not None \
                and now - cached[0] < self._PODS_TTL_S:
            return cached[1]
        out = self._t("GET", self.PODS_PATH.format(ns=self._ns)
                      + f"?labelSelector={sel}")
        pods = [p for p in out.get("items", [])
                if not p.get("metadata", {}).get("deletionTimestamp")
                and p.get("status", {}).get("phase") in ("Pending",
                                                         "Running")]
        self._pods_cache[sel] = (now, pods)
        return pods

    @staticmethod
    def _pod_name(pod: dict) -> str:
        return pod["metadata"]["name"]

    @staticmethod
    def _pod_group(pod: dict) -> Optional[str]:
        return pod["metadata"].get("labels", {}).get("ray.io/group")

    @staticmethod
    def _replica_index(pod: dict) -> Optional[str]:
        return pod["metadata"].get("labels", {}).get(
            "ray.io/replica-index")

    # ------------------------------------------------------------- gangs
    def create_node_group(self, node_type: str,
                          node_config: Dict[str, Any],
                          gang_size: int) -> str:
        """Scale the multi-host worker group by ONE replica (= a gang of
        ``numOfHosts`` pods) and wait for its pods to appear."""
        before = {self._pod_name(p)
                  for p in self._pods(f"ray.io/group={node_type}")}

        def bump(cr):
            spec = self._group_spec(cr, node_type)
            hosts = int(spec.get("numOfHosts", 1))
            if gang_size > 1 and hosts != gang_size:
                raise KubeRayError(
                    f"group {node_type!r} has numOfHosts={hosts}, "
                    f"cannot launch a {gang_size}-host gang")
            spec["replicas"] = int(spec.get("replicas", 0)) + 1

        self._update_cr(bump)

        deadline = time.monotonic() + self._ready_timeout
        fresh: List[dict] = []
        while time.monotonic() < deadline:
            fresh = [p for p in self._pods(f"ray.io/group={node_type}",
                                           fresh=True)
                     if self._pod_name(p) not in before]
            if len(fresh) >= gang_size and all(
                    p["status"].get("phase") == "Running" for p in fresh):
                idx = self._replica_index(fresh[0])
                if gang_size > 1 and idx is None:
                    raise KubeRayError(
                        "operator did not label the multi-host replica "
                        "(ray.io/replica-index missing)")
                return idx if idx is not None else self._pod_name(fresh[0])
            time.sleep(self._poll)

        # Roll back the replica bump AND name the stuck gang's pods in
        # workersToDelete — a bare decrement would let the operator
        # reconcile away an arbitrary (possibly healthy, in-use) replica
        # while the unschedulable one survives.
        stuck = [self._pod_name(p) for p in fresh]

        def rollback(cr):
            spec = self._group_spec(cr, node_type)
            spec["replicas"] = max(0, int(spec.get("replicas", 1)) - 1)
            if stuck:
                dele = spec.setdefault("scaleStrategy", {}).setdefault(
                    "workersToDelete", [])
                for n in stuck:
                    if n not in dele:
                        dele.append(n)

        self._update_cr(rollback)
        raise KubeRayError(
            f"gang for group {node_type!r} not Running within "
            f"{self._ready_timeout}s")

    def terminate_node_group(self, group_id: str) -> None:
        pods = [p for p in self._pods()
                if self._replica_index(p) == group_id
                or self._pod_name(p) == group_id]
        if not pods:
            return
        node_type = self._pod_group(pods[0])
        names = [self._pod_name(p) for p in pods]

        def shrink(cr):
            spec = self._group_spec(cr, node_type)
            spec["replicas"] = max(0, int(spec.get("replicas", 1)) - 1)
            strat = spec.setdefault("scaleStrategy", {})
            dele = strat.setdefault("workersToDelete", [])
            for n in names:
                if n not in dele:
                    dele.append(n)

        self._update_cr(shrink)

    def node_groups(self) -> List[str]:
        seen = []
        for p in self._pods():
            gid = self._replica_index(p) or self._pod_name(p)
            if gid not in seen:
                seen.append(gid)
        return seen

    def group_nodes(self, group_id: str) -> List[str]:
        return sorted(
            self._pod_name(p) for p in self._pods()
            if (self._replica_index(p) or self._pod_name(p)) == group_id)

    def group_type_of(self, group_id: str) -> Optional[str]:
        for p in self._pods():
            if (self._replica_index(p) or self._pod_name(p)) == group_id:
                return self._pod_group(p)
        return None

    # ---------------------------------------------- NodeProvider surface
    def create_node(self, node_type: str,
                    node_config: Dict[str, Any]) -> str:
        return self.create_node_group(node_type, node_config, 1)

    def terminate_node(self, provider_node_id: str) -> None:
        pod = next((p for p in self._pods()
                    if self._pod_name(p) == provider_node_id), None)
        if pod is None:
            return
        if self._replica_index(pod) is not None:
            # A gang member cannot be deleted alone — the gang lives
            # and dies together (same contract as the Compute Engine
            # provider).
            self.terminate_node_group(self._replica_index(pod))
            return
        self.terminate_node_group(provider_node_id)

    def non_terminated_nodes(self) -> List[str]:
        return sorted(self._pod_name(p) for p in self._pods())

    def node_type_of(self, provider_node_id: str) -> Optional[str]:
        for p in self._pods():
            if self._pod_name(p) == provider_node_id:
                return self._pod_group(p)
        return None

    def internal_node_id(self, provider_node_id: str) -> Optional[bytes]:
        """Pod IP <-> GCS raylet address (k8s pods have stable IPs and
        ``python -m ray_tpu_torch start`` binds the pod IP; no label
        plumbing needed)."""
        cached = self._internal_ids.get(provider_node_id)
        if cached is not None:
            return cached
        pod = next((p for p in self._pods()
                    if self._pod_name(p) == provider_node_id), None)
        ip = pod and pod.get("status", {}).get("podIP")
        if not ip:
            return None
        nodes = self._node_table()
        for n in nodes or []:
            addr = n.get("addr") or ("", 0)
            if addr[0] == ip and n.get("state") == "ALIVE":
                self._internal_ids[provider_node_id] = n["node_id"]
                return n["node_id"]
        return None

