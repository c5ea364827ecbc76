"""mesh.idle_pct: the share of the traced window in which rank 0's card of
a mesh ran no operation, 100 * (1 - busy / window); serve.idle_pct's
reading, for the cells that report mesh_tiles_per_s."""

from benchmarks import harness

read = harness.metric_reader("serve.idle_pct")
