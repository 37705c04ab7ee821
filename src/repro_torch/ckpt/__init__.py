"""Checkpointing of the port's training state (npz shards, manifest)."""
