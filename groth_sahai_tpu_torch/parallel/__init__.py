"""Mesh / sharding layer: sharded MSM, pairing and batch verification
over one or more cards and processes (torch.distributed)."""
