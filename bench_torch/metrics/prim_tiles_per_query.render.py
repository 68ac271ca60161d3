"""prim_tiles_per_query.render: the tiles whose rows K4 tested a warp query:
over the traced renders, the sizes of the ``render.prim.tiles`` records in
the program's span log (``path_tracer_tpu_torch.utils.profiling.spans``;
per render ``RenderStats.extra["prim_tiles"]``, the tiles each warp query
entered closer than its best hit so far) over the sizes of their
``render.prim.query`` records (``prim_queries``: the segments whose line
enters a tile, which K4 traces with a whole warp). The warp queries' share
of the segments (the ``render.prim`` records) is printed beside it. A
program without the records, or renders of another route, report
nothing."""


def read(ctx, out):
    from path_tracer_tpu_torch.utils import profiling

    if out.trace is None or not hasattr(profiling, "spans"):
        return None
    size = {}
    for s in profiling.spans():
        if s.name in ("render.prim", "render.prim.query", "render.prim.tiles"):
            size[s.name] = size.get(s.name, 0) + (s.size or 0)
    queries = size.get("render.prim.query", 0)
    if queries <= 0:
        return None
    tiles, segments = size.get("render.prim.tiles", 0), size.get("render.prim", 0)
    share = f"{queries / segments:.6g}" if segments else "unknown"
    print(f"prim_tiles_per_query.render: {tiles} tiles over {queries} warp "
          f"queries; warp-query share of segments {share} ({segments})",
          flush=True)
    return tiles / queries
