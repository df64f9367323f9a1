"""Zero-downtime fleet serving of the port (mirrors
``mxnet_tpu.serving.fleet``): a multi-model router with atomic weight
hot-swap, per-tenant quotas, priority lanes, and a continuous
fine-tune->publish loop."""
from .metrics import FleetStats
from .quota import LANES, TenantQuota, TokenBucket
from .router import PUBLISH_PHASES, FleetRouter
from .trainloop import FineTunePublisher

__all__ = ["FleetRouter", "FleetStats", "FineTunePublisher", "LANES",
           "PUBLISH_PHASES", "TenantQuota", "TokenBucket"]
