"""``mrays_per_s``: the rays cast (``trace_persistent(..., with_stats=True)``)
over the render spans' seconds (millions a second)."""


def read(run):
    rays = [r["rays"] for r in run.frames if "rays" in r]
    if not rays or not run.spans or not run.spans.get("render"):
        return None
    return sum(rays) / sum(run.spans["render"]) / 1e6
