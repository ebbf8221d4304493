"""Traffic: one driver per kind (``<kind>.py``: ``setup``, ``window``,
``close``, ``check``) and one data file per mix (``<mix>.json``, whose
``kind`` names its driver)."""
