"""The run bracket (``runtime.execute_plan``). The JAX package's plan IR,
multi-plan executor, journal, leases and prefix dedup are not ported
(see ROADMAP.md)."""
