"""The paper's evaluation on the port's functions, as the reference's
``benchmarks/`` builds it: ``throughput_bench`` (Fig. 7),
``bound_convergence`` (Fig. 8), ``fct_bench`` (Fig. 5/6: FCT and
utilization of every system over load, CPU-vs-device timing tables),
``adaptive_bench`` (the closed loop: policies, construction charging, the
epoch tradeoff, gather staleness, faults and repair, CPU-vs-device
timing), ``schedule_time`` (Fig. 10: construction latency, host only),
``interconnect_bench`` (the interconnect pricing) and ``run``, the
harness that runs them all and writes the ``BENCH_*.json`` files.  The
analytic numbers and schedule construction are host numpy/scipy; the
flow-level runs (``run_sweep`` / ``run_adaptive``) and every saturate
schedule's Sinkhorn projection run on ``device`` (``None``: the card)."""
