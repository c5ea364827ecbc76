"""mfu.mesh_bf16: the bf16 model operations of a mesh over the traced
window, as a share of all its cards' bf16 peak; mfu.serve_bf16's reading
(tiles of every rank over window x peak x cards), for the cells that
report mesh_tiles_per_s."""

from benchmarks import harness

read = harness.metric_reader("mfu.serve_bf16")
