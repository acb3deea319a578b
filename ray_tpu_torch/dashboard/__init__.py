"""ray_tpu_torch.dashboard — the cluster web UI / REST head.

Reference: `dashboard/head.py` + `dashboard/state_aggregator.py` — an
aiohttp server on the head node aggregating GCS + raylet state into REST
endpoints and a browser page.
"""
