"""Image-classification serving: export, dynamic batching, replicas."""

from theanompi_tpu_torch.serving.batcher import (  # noqa: F401
    BatchPolicy,
    DynamicBatcher,
    Overloaded,
)
from theanompi_tpu_torch.serving.export import (  # noqa: F401
    IncompatibleExport,
    InferenceSession,
    export_model,
    load_export,
)
from theanompi_tpu_torch.serving.server import InferenceServer  # noqa: F401
