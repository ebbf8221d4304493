from waternet_tpu_torch.models.waternet import (  # noqa: F401
    ConfidenceMapGenerator,
    Refiner,
    WaterNet,
    waternet_forward_flops,
)
