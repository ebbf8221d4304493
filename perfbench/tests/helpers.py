"""Tiny sizes of each cell for the CPU tests."""

TINY = {
    "waternet.video_1080p": {"mix.height": 40, "mix.width": 56, "mix.frames_per_call": 2, "mix.pool_calls": 2,
                             "mix.warmup_calls": 1, "settings.profile_seconds": 0.3},
    "can24.video_1080p": {"mix.height": 40, "mix.width": 56, "mix.frames_per_call": 2, "mix.pool_calls": 2,
                          "mix.warmup_calls": 1, "settings.profile_seconds": 0.3},
    "waternet.train_fullres": {"mix.pairs": 16, "mix.height": 32, "mix.width": 32, "mix.batch": 4,
                               "settings.profile_seconds": 0.3},
    "waternet.serve_mixed_inproc": {
        "mix.shapes": [[30, 40], [45, 60], [60, 80], [31, 41], [44, 61], [58, 79]],
        "mix.buckets": [[31, 41], [45, 61], [60, 80]], "mix.rate_per_s": 8.0,
        "settings.profile_seconds": 0.3, "settings.check_requests": 4},
}
SEED = 2 ** 31 + 977
