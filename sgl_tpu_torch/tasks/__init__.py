from sgl_tpu_torch.tasks.node_classification import NodeClassification  # noqa: F401
