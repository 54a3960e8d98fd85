from repro_torch.fleet.arbiter import FleetArbiter, ResourceClaim  # noqa: F401
