"""The batcher's share of batch slots that held a real request, over the
run (``ServingStats.summary()["batch_occupancy"]``), in percent."""


def read(run):
    occ = run.host.get("batch_occupancy")
    return 100.0 * occ if occ else None
