"""Serving: export (f32/bf16/int8), dynamic batching, replicas, the
decode path's server branch, the TCP front and its client."""

from theanompi_tpu_torch.serving.batcher import (  # noqa: F401
    BatchPolicy,
    DynamicBatcher,
    Overloaded,
    default_buckets,
    pick_bucket,
)
from theanompi_tpu_torch.serving.export import (  # noqa: F401
    IncompatibleExport,
    InferenceSession,
    LoadedExport,
    build_model_from_meta,
    dequantize_tree,
    draft_incompatibility,
    export_incompatibility,
    export_model,
    latest_export_version,
    load_export,
    quantize_tree,
)
from theanompi_tpu_torch.serving.server import (  # noqa: F401
    DEFAULT_PORT,
    InferenceClient,
    InferenceServer,
    Replica,
    serve,
    serve_main,
)
