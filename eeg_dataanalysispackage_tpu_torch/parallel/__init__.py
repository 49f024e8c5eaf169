"""Member-axis training engines (the JAX package's ``parallel/``); the
mesh-sharded engines are not ported yet (see ROADMAP.md)."""
