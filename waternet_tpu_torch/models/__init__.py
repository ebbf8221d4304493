from waternet_tpu_torch.models.can import CANStudent  # noqa: F401
from waternet_tpu_torch.models.waternet import (  # noqa: F401
    ConfidenceMapGenerator,
    Refiner,
    WaterNet,
    waternet_forward_flops,
)
