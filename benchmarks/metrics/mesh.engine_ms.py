"""mesh.engine_ms: serve.engine_ms's reading on rank 0 of a mesh, where
every rank uploads, cuts and stitches the whole request; for the cells that
report mesh_tiles_per_s."""

from benchmarks import harness

read = harness.metric_reader("serve.engine_ms")
