"""Frame batches: the batch engine, the datalist prefetcher, the
throughput totals and the data-parallel launcher (port of
``rpcc_tpu/parallel``: one engine process per device in place of the mesh).
Import the submodules directly; this package imports nothing itself."""
