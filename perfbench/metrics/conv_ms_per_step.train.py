"""Device milliseconds under ``aten::convolution`` and
``aten::convolution_backward`` per training step, over the host-recorded
half of the profiled sub-window."""


def read(run):
    steps = run.profile_units.get("host")
    if not run.profile or not steps:
        return None
    ops = run.profile["op_device_s"]
    sec = ops.get("aten::convolution", 0.0) + ops.get("aten::convolution_backward", 0.0)
    return sec / steps * 1e3 if sec else None
