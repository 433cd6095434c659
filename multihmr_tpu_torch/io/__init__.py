from multihmr_tpu_torch.io.export import (  # noqa: F401
    export_model,
    load_exported,
)
