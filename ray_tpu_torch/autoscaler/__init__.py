from ray_tpu_torch.autoscaler.autoscaler import StandardAutoscaler
from ray_tpu_torch.autoscaler.node_provider import (
    FakeMultiNodeProvider, NodeProvider,
)

__all__ = ["FakeMultiNodeProvider", "NodeProvider", "StandardAutoscaler"]
