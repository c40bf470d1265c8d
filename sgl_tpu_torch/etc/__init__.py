from sgl_tpu_torch.etc.auto_select_edge_type_for_nars import (  # noqa: F401
    hetero_search,
    select_top_subgraphs,
    subgraph_weight_stability,
)
