"""Vermilion core of the port: traffic matrices, Algorithm 1 schedule
construction and its baselines, the throughput theory and interconnect
pricing (host numpy/scipy), fault injection (host numpy), and the flow
simulator whose data plane runs on the card.

Re-exports what ``repro.core`` exports, under the same names, except
``simulate_aggregate_jax``, whose counterpart here is
:func:`repro_torch.core.simulator.simulate_aggregate`; and the names of
:mod:`repro_torch.core.faults`.
"""
from .traffic import (
    hose_normalize,
    is_hose,
    saturate,
    uniform,
    ring,
    permutation,
    skewed,
    dlrm_data_parallel,
    dlrm_hybrid_parallel,
    random_hose,
    pattern_matrix,
    phase_train,
)
from .rounding import round_matrix, round_matrices, check_rounding
from .matching import (
    decompose_matchings,
    decompose_matchings_euler,
    extract_perfect_matching,
    is_regular,
)
from .schedule import (
    Schedule,
    vermilion_schedule,
    vermilion_emulated_topology,
    per_node_schedules,
    effective_perms,
    schedule_disagreement,
    oblivious_schedule,
    greedy_matching_schedule,
    bvn_schedule,
    bvn_decompose,
    quantize_bvn,
    spread_matchings,
)
from .throughput import (
    throughput_single_hop,
    throughput_multi_hop,
    schedule_throughput,
    vermilion_throughput,
    oblivious_throughput,
    theorem3_bound,
)
from .faults import (
    FAULT_KINDS,
    FaultEvent,
    FaultSchedule,
    FaultTimeline,
    claims_fault_mask,
)
from .simulator import (
    Workload,
    websearch_workload,
    phase_shifting_workload,
    SimResult,
    SweepCase,
    SweepRow,
    AdaptiveCase,
    AdaptiveRow,
    simulate,
    run_sweep,
    run_adaptive,
    simulate_aggregate,
)
from .estimation import (
    RingViews,
    TrafficEstimator,
    allgather_rows,
    dequantize,
    estimate_all_views,
    estimate_global_matrix,
    quantize_row,
    ring_all_views,
    ring_leader_view,
    ring_view_mask,
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
