"""Device meshes and the engines over them (the JAX package's
``parallel/``): single-process meshes, the sharded ingest, the member-axis
population engines and the data-parallel MLP trainers; the multi-process
half is not ported yet (see ROADMAP.md)."""
