"""Vermilion core of the port: traffic matrices, Algorithm 1 schedule
construction, and the batched single-hop sweep whose data plane runs on
the card."""
