"""See :func:`perfbench.metrics._stages.device_ms_per_frame`, over the
blocks' ``model.gdfn`` spans (``models/restormer.py``), times the blocks a
forward runs: the GDFN halves' device milliseconds a frame."""

from perfbench.metrics._stages import device_ms_per_frame


def read(run):
    per_block = device_ms_per_frame(run, "model.gdfn")
    if per_block is None:
        return None
    nb = run.config["num_blocks"]
    return per_block * (2 * sum(nb[:3]) + nb[3] + run.config["num_refinement_blocks"])
