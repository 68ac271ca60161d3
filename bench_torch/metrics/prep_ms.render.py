"""prep_ms.render: the host time of the program's ``pipeline.prepare_render``
a render, in ms: the mean of the span the render kind records around each
call (the scene's packing and tables, built anew every render)."""


def read(ctx, out):
    spans = out.spans.get("prepare_render")
    return 1e3 * sum(spans) / len(spans) if spans else None
