"""mesh.gather_ms: device milliseconds per call of the tile engine's gather
over the mesh (parallel/mesh.py's all_gather_cat, the span 'gather'), on
rank 0's card: the collective and the join of the blocks.

The profiler ties no host launch to an NCCL kernel (NCCL launches its
kernels itself), so the collective's kernels are counted by name; the
serving window runs no other NCCL collective."""


def read(t):
    n = len(t.calls.get("gather", []))
    device_s = t.span_device_s("gather") + sum(
        b - a for a, b, name, span in t.ops if span != "gather" and name.startswith("nccl")) / 1e6
    if not n or device_s <= 0:
        return None
    return 1e3 * device_s / n
