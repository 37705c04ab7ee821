"""The paper's throughput figures and the interconnect pricing, as the
reference's ``benchmarks/throughput_bench.py`` (Fig. 7),
``bound_convergence.py`` (Fig. 8) and ``interconnect_bench.py`` build
them, on the port's functions.  The analytic numbers are host numpy/scipy;
the flow-level cross-checks build saturate schedules (the Sinkhorn kernel)
and run them through :func:`repro_torch.core.simulator.run_sweep` on
``device`` (``None``: the card)."""
