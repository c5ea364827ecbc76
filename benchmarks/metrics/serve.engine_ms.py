"""serve.engine_ms: device milliseconds per request of the tile engine's
own work around the model (infer/tiles.py's spans 'tiles.upload',
'tiles.cut', 'tiles.argmax', 'tiles.stitch' and 'tiles.metrics'): the
frames' and labels' upload, the normalization, mirror pad, cut and fill,
the argmax, the stitch and the metrics, on rank 0's card on a mesh."""

from benchmarks.program_spans import device_ms

SPANS = ("tiles.upload", "tiles.cut", "tiles.argmax", "tiles.stitch", "tiles.metrics")


def read(t):
    return device_ms(t, SPANS, "requests")
