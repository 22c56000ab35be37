"""Block-sparse serving of pruned checkpoints: bundles of params and tile
keeps (``export``), tile-masked linears (``sparse``), the llama-family
decode / prefill model with dead-head skips (``model``) and the
continuous-batching engine (``engine``)."""

from repro_torch.serve.engine import ServeConfig, ServeEngine  # noqa: F401
from repro_torch.serve.export import (  # noqa: F401
    PrunedBundle, export_from_result, export_pruned, load_pruned,
    make_bundle)
from repro_torch.serve.model import SparseModel  # noqa: F401
from repro_torch.serve.sparse import IMPLS, apply_linear, make_linear  # noqa: F401
