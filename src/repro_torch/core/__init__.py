"""Vermilion core of the port: traffic matrices, Algorithm 1 schedule
construction and its baselines, the throughput theory and interconnect
pricing (host numpy/scipy), and the batched sweep whose data plane runs on
the card."""
from .schedule import (
    bvn_schedule,
    bvn_decompose,
    quantize_bvn,
)
from .throughput import (
    throughput_single_hop,
    throughput_multi_hop,
    schedule_throughput,
    vermilion_throughput,
    oblivious_throughput,
    theorem3_bound,
)
from .collectives import (
    ring_allreduce_traffic,
    all_to_all_traffic,
    pipeline_traffic,
    hierarchical_traffic,
    training_step_traffic,
    InterconnectModel,
)

__all__ = [k for k in dir() if not k.startswith("_")]
