"""Frame batches on one device: the batch engine, the datalist prefetcher
and the throughput totals (port of ``rpcc_tpu/parallel``, without the mesh:
one engine drives one card).  Import the submodules directly; this package
imports nothing itself."""
