"""Host milliseconds of scene prep per frame or skybox: the span the
benchmark records around ``cuda_render.prepare`` (stills) or
``batch._scene_groups`` (skyboxes) in the traced run, summed over the
window and divided by its frames or skyboxes."""


def read(rec):
    secs = rec["spans"].get("host_prep", [])
    if not secs or rec["units"] <= 0:
        return None
    return 1e3 * sum(secs) / rec["units"]
